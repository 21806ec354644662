"""Reference-compatible config & beliefs file parsing/writing.

GP_emu_UQSA's entire UX is two whitespace key/value text files plus
whitespace-separated data matrices (SURVEY.md S3 Config/Beliefs parsers,
S6 "Config / flag system" — the load-bearing compatibility surface):

  config file:   beliefs/inputs/outputs paths, `tv_config a b c`,
                 `delta_bounds [...]`, `sigma_bounds [...]`, `tries N`,
                 `constraints ...`
  beliefs file:  `active`, `output`, `basis_str`/`basis_inf`, `beta`,
                 `fix_mean`, `mucm T|F`, `kernel gaussian()`, `delta`,
                 `sigma`, `nugget`, `fix_nugget`, `input_minmax` (written
                 back after training as the checkpoint mechanism, S7.4)

The parsers are tolerant: unknown keys are preserved in `extra` and written
back verbatim, so round-tripping a reference file is lossless.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Optional


def _parse_bool(tok: str) -> bool:
    return tok.strip().upper() in ("T", "TRUE", "1", "Y", "YES")


def _fmt_bool(b: bool) -> str:
    return "T" if b else "F"


def _parse_bounds(text: str):
    """Parse `[ ]` / `[(0.1, 1.0), (0.1, 1.0)]`-style bounds lists."""
    text = text.strip()
    if text in ("[]", "[ ]", ""):
        return None
    val = ast.literal_eval(re.sub(r"\s+", " ", text))
    if not val:
        return None
    return [tuple(map(float, pair)) for pair in val]


def _read_kv_lines(path) -> list[tuple[str, str]]:
    out = []
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        out.append((parts[0], parts[1] if len(parts) > 1 else ""))
    return out


@dataclasses.dataclass
class Config:
    """Parsed reference config file (reference `Config`, SURVEY.md S3)."""

    beliefs: str = "beliefs"
    inputs: str = "inputs"
    outputs: str = "outputs"
    tv_config: tuple[int, int, int] = (10, 0, 2)  # n_sets, first_V_set, n_V_sets
    delta_bounds: Optional[list] = None
    sigma_bounds: Optional[list] = None
    nugget_bounds: Optional[list] = None
    tries: int = 1
    constraints: str = "bounds"   # "bounds" | "none" | "standard"
    extra: dict = dataclasses.field(default_factory=dict)
    path: Optional[str] = None

    @classmethod
    def from_file(cls, path) -> "Config":
        cfg = cls(path=str(path))
        base = Path(path).parent
        for key, val in _read_kv_lines(path):
            if key in ("beliefs", "inputs", "outputs"):
                p = Path(val.strip())
                setattr(cfg, key, str(p if p.is_absolute() else base / p))
            elif key == "tv_config":
                cfg.tv_config = tuple(int(t) for t in val.split()[:3])
            elif key in ("delta_bounds", "sigma_bounds", "nugget_bounds"):
                setattr(cfg, key, _parse_bounds(val))
            elif key == "tries":
                cfg.tries = int(val)
            elif key == "constraints":
                tok = val.strip()
                cfg.constraints = {
                    "T": "bounds", "F": "none", "true": "bounds", "false": "none"
                }.get(tok, tok.lower())
            else:
                cfg.extra[key] = val
        return cfg

    def to_file(self, path) -> None:
        lines = [
            f"beliefs {self.beliefs}",
            f"inputs {self.inputs}",
            f"outputs {self.outputs}",
            "tv_config " + " ".join(str(v) for v in self.tv_config),
            f"delta_bounds {list(self.delta_bounds) if self.delta_bounds else '[ ]'}",
            f"sigma_bounds {list(self.sigma_bounds) if self.sigma_bounds else '[ ]'}",
            f"tries {self.tries}",
            f"constraints {self.constraints}",
        ]
        if self.nugget_bounds:
            lines.append(f"nugget_bounds {list(self.nugget_bounds)}")
        lines += [f"{k} {v}" for k, v in self.extra.items()]
        Path(path).write_text("\n".join(lines) + "\n")


@dataclasses.dataclass
class Beliefs:
    """Parsed reference beliefs file (reference `Beliefs`, SURVEY.md S3)."""

    active: Optional[list[int]] = None     # None => "all"
    output: int = 0
    basis_str: list[str] = dataclasses.field(default_factory=lambda: ["1.0"])
    basis_inf: list[str] = dataclasses.field(default_factory=lambda: ["NA"])
    beta: list[float] = dataclasses.field(default_factory=lambda: [1.0])
    fix_mean: bool = False
    mucm: bool = True                      # concentrated likelihood
    kernel: str = "gaussian()"
    delta: list[float] = dataclasses.field(default_factory=lambda: [1.0])
    sigma: float = 1.0
    nugget: float = 0.0
    fix_nugget: bool = True
    input_minmax: Optional[list] = None    # written back post-scaling
    extra: dict = dataclasses.field(default_factory=dict)
    path: Optional[str] = None

    @classmethod
    def from_file(cls, path) -> "Beliefs":
        b = cls(path=str(path))
        for key, val in _read_kv_lines(path):
            toks = val.split()
            if key == "active":
                b.active = None if val.strip().lower() == "all" else [
                    int(t) for t in toks
                ]
            elif key == "output":
                b.output = int(toks[0])
            elif key == "basis_str":
                b.basis_str = toks
            elif key == "basis_inf":
                b.basis_inf = toks
            elif key == "beta":
                b.beta = [float(t) for t in toks]
            elif key == "fix_mean":
                b.fix_mean = _parse_bool(toks[0])
            elif key == "mucm":
                b.mucm = _parse_bool(toks[0])
            elif key == "kernel":
                b.kernel = val.strip()
            elif key == "delta":
                b.delta = [float(t) for t in toks]
            elif key == "sigma":
                b.sigma = float(toks[0])
            elif key == "nugget":
                b.nugget = float(toks[0])
            elif key == "fix_nugget":
                b.fix_nugget = _parse_bool(toks[0])
            elif key == "input_minmax":
                b.input_minmax = ast.literal_eval(re.sub(r"\s+", " ", val))
            else:
                b.extra[key] = val
        b.kernel_family()  # validate the kernel spec early
        return b

    def kernel_family(self) -> str:
        """Beliefs `kernel` line -> correlation-family name (kernels.py).

        The reference only supports `gaussian()`; matern/exponential are a
        capability extension (UQSA analytics still require gaussian and the
        sensitivity setup enforces that separately).
        """
        name = self.kernel.strip().lower().rstrip("()")
        aliases = {
            "gaussian": "gaussian",
            "squared_exponential": "gaussian",
            "matern52": "matern52",
            "matern_5_2": "matern52",
            "matern32": "matern32",
            "matern_3_2": "matern32",
            "exponential": "exponential",
        }
        if name not in aliases:
            raise ValueError(
                f"unsupported kernel {self.kernel!r}: expected one of "
                f"{sorted(set(aliases))}"
            )
        return aliases[name]

    def to_file(self, path) -> None:
        lines = [
            "active " + ("all" if self.active is None else " ".join(map(str, self.active))),
            f"output {self.output}",
            "basis_str " + " ".join(self.basis_str),
            "basis_inf " + " ".join(self.basis_inf),
            "beta " + " ".join(f"{v:.10g}" for v in self.beta),
            f"fix_mean {_fmt_bool(self.fix_mean)}",
            f"mucm {_fmt_bool(self.mucm)}",
            f"kernel {self.kernel}",
            "delta " + " ".join(f"{v:.10g}" for v in self.delta),
            f"sigma {self.sigma:.10g}",
            f"nugget {self.nugget:.10g}",
            f"fix_nugget {_fmt_bool(self.fix_nugget)}",
        ]
        if self.input_minmax is not None:
            lines.append(f"input_minmax {self.input_minmax}")
        lines += [f"{k} {v}" for k, v in self.extra.items()]
        Path(path).write_text("\n".join(lines) + "\n")
