"""Mean-function basis h(x) for universal kriging (port of `gp_emu_uqsa_tpu.basis`).

Reference parity: GP_emu_UQSA beliefs files specify the basis via
`basis_str` / `basis_inf` (constant `1.0` plus per-input terms — linear by
default, with user-specifiable monomials such as `x**2`; SURVEY.md S3
"Mean basis"). `BasisSpec` holds a constant term, a subset of linear terms
and monomial power terms `x_i**p` (p >= 2). `fix_mean` is handled at the GP
level by an empty basis and a fixed beta offset.

The UQSA closed-form integrals rely on the basis being AT MOST LINEAR (the
MUCM requirement); emulation and prediction accept power terms.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class BasisSpec(NamedTuple):
    """Constant + linear-subset + monomial-power mean basis.

    Attributes:
      include_const: include the constant 1.0 column (reference default).
      linear_dims: indices (into the *active-input* columns of X) that get a
        linear term, in order. Empty tuple => no linear terms.
      power_terms: (dim, power) pairs appended as x_dim**power columns
        (power >= 2); the beliefs-file "user-specified basis function"
        surface. Column order is: const, linear terms, power terms.
    """

    include_const: bool = True
    linear_dims: tuple[int, ...] = ()
    power_terms: tuple[tuple[int, int], ...] = ()

    @property
    def q(self) -> int:
        return (int(self.include_const) + len(self.linear_dims)
                + len(self.power_terms))

    @property
    def is_linear(self) -> bool:
        """True when the basis is MUCM-analytic-UQSA compatible (<= linear)."""
        return not self.power_terms


def linear_basis(d: int) -> BasisSpec:
    """The reference's default basis h(x) = [1, x_1, ..., x_d]."""
    return BasisSpec(True, tuple(range(d)))


def const_basis() -> BasisSpec:
    """h(x) = [1]."""
    return BasisSpec(True, ())


def basis_matrix(x: torch.Tensor, spec: BasisSpec) -> torch.Tensor:
    """H with rows h(x_i)^T, shape (n, q), on x's device and dtype."""
    d = x.shape[1]
    # validate input-dim references eagerly, as the JAX package does: a
    # beliefs file whose basis_inf exceeds the active dims must not train
    # the wrong mean silently
    bad = [i for i in spec.linear_dims if not 0 <= i < d] + [
        dim for dim, _ in spec.power_terms if not 0 <= dim < d]
    if bad:
        raise ValueError(
            f"basis references input dim(s) {bad} but X has {d} columns "
            "(check basis_inf against the active inputs)")
    cols = []
    if spec.include_const:
        cols.append(torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device))
    if spec.linear_dims:
        cols.append(x[:, list(spec.linear_dims)])
    for dim, power in spec.power_terms:
        cols.append(x[:, dim:dim + 1] ** power)
    if not cols:
        return torch.zeros((x.shape[0], 0), dtype=x.dtype, device=x.device)
    return torch.cat(cols, dim=1)


def _parse_power_token(token: str) -> int | None:
    """'x**3' / 'x^3' / 'x[k]**3' -> 3; None when not a power form."""
    stripped = token
    # drop an optional [k] index (the input dim comes from basis_inf,
    # reference format) so 'x[2]**2' parses like 'x**2'
    if stripped.startswith("x[") and "]" in stripped:
        stripped = "x" + stripped[stripped.index("]") + 1:]
    for sep in ("**", "^"):
        if stripped.startswith("x" + sep):
            try:
                return int(stripped[1 + len(sep):])
            except ValueError:
                return None
    return None


def parse_basis_strings(basis_str: Sequence[str], basis_inf: Sequence[str]) -> BasisSpec:
    """Parse the reference beliefs-file basis description.

    `basis_str` like ["1.0", "x", "x**2"] and `basis_inf` like
    ["NA", "0", "1"] (a token per basis function, with basis_inf giving the
    input index or NA for the constant). Accepted function tokens: constant
    ("1.0"/"1"/"const"), linear ("x" or "x[i]"), and monomial powers
    ("x**p" / "x^p" / "x[i]**p", p >= 2).
    """
    include_const = False
    linear: list[int] = []
    powers: list[tuple[int, int]] = []

    def dim_of(fn: str, inf: str) -> int:
        try:
            return int(inf)
        except ValueError:
            raise ValueError(
                f"basis function {fn!r} needs an integer input index in "
                f"basis_inf, got {inf!r} (check basis_str/basis_inf "
                "alignment; 'NA' is only valid for the constant)"
            ) from None

    for fn, inf in zip(basis_str, basis_inf):
        token = fn.strip().lower().replace(" ", "")
        if token in ("1.0", "1", "const"):
            include_const = True
        elif token == "x" or (
            token.startswith("x[") and token.endswith("]")
        ):
            linear.append(dim_of(fn, inf))
        else:
            p = _parse_power_token(token)
            if p is None or p < 1:
                raise ValueError(
                    f"unsupported basis function {fn!r}: accepted forms are "
                    "constant ('1.0'), linear ('x'), and monomial powers "
                    "('x**p')"
                )
            if p == 1:
                linear.append(dim_of(fn, inf))
            else:
                powers.append((dim_of(fn, inf), p))
    return BasisSpec(include_const, tuple(linear), tuple(powers))


def basis_strings(spec: BasisSpec) -> tuple[list[str], list[str]]:
    """BasisSpec -> (basis_str, basis_inf) in the reference file format.

    Inverse of parse_basis_strings (checkpoint/beliefs write-back)."""
    strs: list[str] = []
    infs: list[str] = []
    if spec.include_const:
        strs.append("1.0")
        infs.append("NA")
    for dim in spec.linear_dims:
        strs.append("x")
        infs.append(str(dim))
    for dim, power in spec.power_terms:
        strs.append(f"x**{power}")
        infs.append(str(dim))
    return strs, infs
