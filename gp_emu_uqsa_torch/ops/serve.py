"""K3/K4: fused serving kernels (CUDA for Hopper) and the fused serving tier.

Port of `gp_emu_uqsa_tpu.ops.serve`. The posterior mean and variance at m
queries need the (m, n) cross-correlation block c* = exp(-D2(X*, X)) only
through two contractions, so neither kernel writes it to device memory:

* K3 `corr_matvec` replaces `corr_matvec_pallas` (`gp_emu_uqsa_tpu/ops/
  serve.py:103`): c* @ rhs, with rhs = [e | A^-1 H] giving the mean's c* e
  and the R-term's c* A^-1 H in one pass (`csrc/corr_matvec.cu`);
* K4 `corr_quad` replaces `corr_quad_pallas` (`:371`): the whitened
  variance quadratic |W c*|^2, W = L^-1 lower-triangular
  (`csrc/corr_quad.cu`).

K3 is bound by its m n (3d + 1 + 2r) fp32 operations on the CUDA cores; it
splits n into segments whose partials a second pass sums in a fixed order
(`corr_matvec_segmented_plain` models that order). K4 has one body per TPU
precision tier: "highest" runs the m n (n + 1) operations of the triangular
product in exact fp32 on the CUDA cores, spreading the factor tiles of a
small request over `quad_splits` blocks (`corr_quad_split_plain` models the
combine), and
"high" (what `Emulator.predict` serves by default) runs them three times as
3xTF32 on the tensor cores (`wgmma`): W and c split into TF32 hi and lo
parts, c_hi W_hi + c_hi W_lo + c_lo W_hi in fp32, within the tier's
<= 4.7e-5 absolute budget on quad (docs/numerics.md). Each kernel rebuilds
its correlation tiles on chip and contracts them at once (design notes in
the sources). `corr_quad_tf32x3_plain` is the "high" body's arithmetic in
plain PyTorch, for the tests and the card check only; on the CPU both tiers
take the fp32 plain version.

Each kernel has a plain PyTorch version here (`*_plain`). The wrapper runs
it only for CPU tensors; for CUDA tensors it launches the kernel or raises.
`launches` on each wrapper counts kernel launches.

The serving functions keep the JAX names without the `_pallas` suffix:
`serve_mean` (`serve_mean_pallas`), `serve_meanvar` (`serve_meanvar_pallas`)
and their `_batched` forms, which loop over query chunks on the host where
the JAX package runs `lax.map` (no padding of the last chunk).
"""
from __future__ import annotations

import ctypes

import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops.kernel_matrix import MAX_D, _check_cuda, sq_exp_plain
from gp_emu_uqsa_torch.ops.precision import fp32_exact

MAX_RHS = 128
_PRECISIONS = ("highest", "high")
_MATVEC_SOURCE = "corr_matvec.cu"
_MATVEC_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)
_MATVEC_SEGMENTS_ARGTYPES = (ctypes.c_int,) * 3
# K3's staging chunk and compensated-fold lengths (csrc/corr_matvec.cu)
MATVEC_CHUNK = 256
MATVEC_FOLD = 64
_QUAD_SOURCE = "corr_quad.cu"
_QUAD_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)
# K4 "highest"'s query and factor tiles (csrc/corr_quad.cu fp::kTileQ,
# fp::kTileK)
QUAD_TILE_Q = 128
QUAD_TILE_K = 256
_QUAD_TF32X3_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p,)


def _check_precision(name: str, value: str) -> None:
    if value not in _PRECISIONS:
        raise ValueError(f"unknown {name} {value!r}; one of {_PRECISIONS}")


def _scaled(xstar, x, delta):
    """fp32 queries and training inputs times 1/delta (the JAX scaling)."""
    xstar = xstar.to(torch.float32)
    x = x.to(torch.float32)
    if xstar.shape[1] != x.shape[1]:
        raise ValueError(f"feature dims differ: xstar has {xstar.shape[1]}, "
                         f"x has {x.shape[1]}")
    inv = 1.0 / torch.as_tensor(delta, dtype=torch.float32, device=x.device)
    return (xstar * inv).contiguous(), (x * inv).contiguous()


@fp32_exact
def corr_matvec_plain(xstar, x, delta, rhs) -> torch.Tensor:
    """Plain version of K3: exp(-D2(xstar/delta, x/delta)) @ rhs in fp32."""
    xs, xt = _scaled(xstar, x, delta)
    return sq_exp_plain(xs, xt) @ rhs.to(torch.float32)


@fp32_exact
def corr_matvec_segmented_plain(xstar, x, delta, rhs, segments: int):
    """K3's summation order in plain PyTorch, for the tests only.

    n is cut into `segments` runs of whole MATVEC_CHUNK-row chunks as the
    kernel's grid.y cuts it; inside a run, each MATVEC_FOLD-row partial is
    added to the running total with Kahan compensation; the runs' totals
    are summed in run order in fp64 and rounded once. (The kernel sums each
    fold's terms one by one; here a matmul does.)
    """
    xs, xt = _scaled(xstar, x, delta)
    rhs = rhs.to(torch.float32)
    n = xt.shape[0]
    chunks = -(-n // MATVEC_CHUNK)
    total = torch.zeros((xs.shape[0], rhs.shape[1]), dtype=torch.float64,
                        device=xs.device)
    for s in range(segments):
        lo = s * chunks // segments * MATVEC_CHUNK
        hi = min(n, (s + 1) * chunks // segments * MATVEC_CHUNK)
        acc = torch.zeros((xs.shape[0], rhs.shape[1]), dtype=torch.float32,
                          device=xs.device)
        comp = torch.zeros_like(acc)
        for f in range(lo, hi, MATVEC_FOLD):
            part = sq_exp_plain(xs, xt[f:f + MATVEC_FOLD]) @ rhs[f:f + MATVEC_FOLD]
            yv = part - comp
            t = acc + yv
            comp = (t - acc) - yv
            acc = t
        total += acc.double()
    return total.to(torch.float32)


def _entry(lib, source: str, symbol: str, argtypes):
    """`symbol` from `lib`, or from `source`'s library built here."""
    if lib is None:
        return _build.kernel(source, symbol, argtypes)
    return _build.entry(lib, symbol, argtypes)


def _matvec_segments(m: int, n: int, r: int, lib=None) -> int:
    fn = _entry(lib, _MATVEC_SOURCE, "gp_corr_matvec_segments",
                _MATVEC_SEGMENTS_ARGTYPES)
    return int(fn(m, n, r))


def _launch_matvec(xs, xt, rhs, out, segments=None, lib=None):
    """csrc/corr_matvec.cu::gp_corr_matvec into out (m, r). `segments`
    defaults to the library's plan for this card; `lib` is another build
    of the source (tools/cuda_core_variants.py)."""
    m, d = xs.shape
    n, r = rhs.shape
    fn = _entry(lib, _MATVEC_SOURCE, "gp_corr_matvec", _MATVEC_ARGTYPES)
    with torch.cuda.device(xs.device):
        if segments is None:
            segments = _matvec_segments(m, n, r, lib)
        partial = (torch.empty((segments, m, r), dtype=torch.float32,
                               device=xs.device) if segments > 1 else out)
        return fn(xs.data_ptr(), xt.data_ptr(), rhs.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), m, n, d, r, segments,
                  _build.stream_ptr(xs))


def corr_matvec(xstar, x, delta, rhs, *,
                rhs_precision: str = "highest") -> torch.Tensor:
    """K3: exp(-D2(xstar/delta, x/delta)) @ rhs without the (m, n) block.

    Counterpart of `corr_matvec_pallas`. xstar: (m, d); x: (n, d); delta:
    (d,); rhs: (n, r) or (n,), r <= 128. Returns (m, r) (or (m,) for a
    vector rhs) in fp32. Both `rhs_precision` tiers run exact fp32.
    """
    _check_precision("rhs_precision", rhs_precision)
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    if rhs.shape[1] > MAX_RHS:
        raise ValueError(f"rhs width {rhs.shape[1]} > {MAX_RHS}; split into "
                         "slabs")
    if rhs.shape[0] != x.shape[0]:
        raise ValueError(f"rhs has {rhs.shape[0]} rows, x has {x.shape[0]}")
    if xstar.device.type == "cpu" and x.device.type == "cpu":
        out = corr_matvec_plain(xstar, x, delta, rhs)
        return out[:, 0] if squeeze else out
    xs, xt = _scaled(xstar, x, delta)
    rhs = rhs.to(torch.float32).contiguous()
    _check_cuda("corr_matvec", xs, xt, rhs)
    m = xs.shape[0]
    n, r = rhs.shape
    out = torch.zeros((m, r), dtype=torch.float32, device=xs.device)
    if m and n and r:
        err = _launch_matvec(xs, xt, rhs, out)
        _build.check(err, _MATVEC_SOURCE, "corr_matvec")
        corr_matvec.launches += 1
    return out[:, 0] if squeeze else out


corr_matvec.launches = 0


@fp32_exact
def corr_quad_plain(xstar, x, delta, w_tri) -> torch.Tensor:
    """Plain version of K4: sum_k (sum_{j<=k} c(x*, x_j) W_kj)^2 in fp32."""
    xs, xt = _scaled(xstar, x, delta)
    u = sq_exp_plain(xs, xt) @ torch.tril(w_tri.to(torch.float32)).T
    return torch.sum(u * u, dim=1)


def quad_splits(m: int, n: int, sms: int) -> int:
    """Blocks that share one query tile's factor tiles in K4 "highest".

    One while the query tiles alone fill the card's `sms` SMs; otherwise as
    many as fill them, at most the (tiles + 1) // 2 pairs of factor tiles.
    """
    q_tiles = -(-m // QUAD_TILE_Q)
    pairs = (-(-n // QUAD_TILE_K) + 1) // 2
    return max(1, min(pairs, sms // max(q_tiles, 1)))


def quad_split_tiles(split: int, splits: int, tiles: int) -> list[int]:
    """The factor tiles one block of K4 "highest" walks, in its order.

    Its pairs are p = split, split + splits, ...; pair p gives tiles p and
    tiles - 1 - p (once when they coincide), so each pair holds the same
    share of the triangle (csrc/corr_quad.cu::k_tile_start).
    """
    out = []
    for p in range(split, (tiles + 1) // 2, splits):
        out += [p] if tiles - 1 - p == p else [p, tiles - 1 - p]
    return out


@fp32_exact
def corr_quad_split_plain(xstar, x, delta, w_tri, splits: int) -> torch.Tensor:
    """K4 "highest"'s split of the factor tiles in plain PyTorch, for the tests.

    u = c @ tril(W)^T in fp32; each of `splits` blocks sums the y^2 of its
    tiles (`quad_split_tiles`) in its order, and the blocks' partials are
    summed in split order, as quad_combine_kernel does.
    """
    xs, xt = _scaled(xstar, x, delta)
    n = xt.shape[0]
    u = sq_exp_plain(xs, xt) @ torch.tril(w_tri.to(torch.float32)).T
    tiles = -(-n // QUAD_TILE_K)
    per_tile = [torch.sum(u[:, t * QUAD_TILE_K:(t + 1) * QUAD_TILE_K] ** 2,
                          dim=1) for t in range(tiles)]
    quad = torch.zeros(xs.shape[0], dtype=torch.float32, device=xs.device)
    for s in range(splits):
        part = torch.zeros_like(quad)
        for t in quad_split_tiles(s, splits, tiles):
            part = part + per_tile[t]
        quad = quad + part
    return quad


def tf32_split(x: torch.Tensor):
    """fp32 x -> (hi, lo), hi = tf32(x) and lo = tf32(x - hi), both fp32.

    TF32 rounding to nearest, ties away from zero (`cvt.rna.tf32.f32` on
    finite inputs) on the int32 view: add half of TF32's last place, then
    clear the 13 mantissa bits the tensor cores ignore. x - hi is exact in
    fp32, so hi + lo is x to about 2^-22 relative.
    """
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


@fp32_exact
def corr_quad_tf32x3_plain(xstar, x, delta, w_tri) -> torch.Tensor:
    """The "high" body's arithmetic in plain PyTorch: 3xTF32, lo*lo dropped.

    c and W are split exactly as the kernel splits them (`tf32_split`) and
    the three products c_hi W_hi + c_hi W_lo + c_lo W_hi are summed in fp32;
    W's strict upper triangle is zeroed first. For the tests and the card
    check; the wrapper never calls it.
    """
    xs, xt = _scaled(xstar, x, delta)
    c_hi, c_lo = tf32_split(sq_exp_plain(xs, xt))
    w_hi, w_lo = tf32_split(torch.tril(w_tri.to(torch.float32)))
    u = c_hi @ w_hi.T + c_hi @ w_lo.T + c_lo @ w_hi.T
    return torch.sum(u * u, dim=1)


def _launch_quad_tf32x3(xs, xt, w, quad, lib=None):
    """csrc/corr_quad.cu::gp_corr_quad_tf32x3 (the "high" body); `lib` is
    another build of the source (tools/k4_high_variants.py)."""
    m, d = xs.shape
    n = xt.shape[0]
    ld = -(-n // 4) * 4            # TMA row strides are multiples of 16 bytes
    xt_t = torch.zeros((d, ld), dtype=torch.float32, device=xs.device)
    xt_t[:, :n] = xt.T
    w_split = torch.empty((2, n, ld), dtype=torch.float32, device=xs.device)
    fn = _entry(lib, _QUAD_SOURCE, "gp_corr_quad_tf32x3",
                _QUAD_TF32X3_ARGTYPES)
    with torch.cuda.device(xs.device):
        return fn(xs.data_ptr(), xt_t.data_ptr(), w.data_ptr(),
                  w_split.data_ptr(), quad.data_ptr(), m, n, d, ld,
                  _build.stream_ptr(xs))


def _launch_quad_fp32(xs, xt, w, quad, splits=None, lib=None):
    """csrc/corr_quad.cu::gp_corr_quad (the "highest" body). `splits`
    defaults to `quad_splits` on this card; `lib` is another build of the
    source (tools/cuda_core_variants.py)."""
    m, d = xs.shape
    n = xt.shape[0]
    ld = -(-n // QUAD_TILE_K) * QUAD_TILE_K
    if splits is None:
        sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
        splits = quad_splits(m, n, sms)
    xt_t = torch.zeros((d, ld), dtype=torch.float32, device=xs.device)
    xt_t[:, :n] = xt.T
    wt = torch.empty((ld, ld), dtype=torch.float32, device=xs.device)
    partial = (torch.empty((splits, m), dtype=torch.float32, device=xs.device)
               if splits > 1 else quad)
    fn = _entry(lib, _QUAD_SOURCE, "gp_corr_quad", _QUAD_ARGTYPES)
    with torch.cuda.device(xs.device):
        return fn(xs.data_ptr(), xt_t.data_ptr(), w.data_ptr(), wt.data_ptr(),
                  partial.data_ptr(), quad.data_ptr(), m, n, d, ld, splits,
                  _build.stream_ptr(xs))


def corr_quad(xstar, x, delta, w_tri, *,
              quad_precision: str = "highest") -> torch.Tensor:
    """K4: quad(x*) = |W c(x*)|^2 = t(x*)^T A^-1 t(x*), (m,) fp32.

    Counterpart of `corr_quad_pallas`. xstar: (m, d); x: (n, d), d <= 20;
    delta: (d,); w_tri: (n, n) with W = L^-1 in its lower triangle (the
    strict upper triangle is never read). On the card "highest" runs the
    exact fp32 body and "high" the 3xTF32 tensor-core body; on the CPU both
    take the fp32 plain version. `launches` counts the launches of both
    bodies.
    """
    _check_precision("quad_precision", quad_precision)
    n = x.shape[0]
    if w_tri.shape != (n, n):
        raise ValueError(f"w_tri has shape {tuple(w_tri.shape)}, expected "
                         f"({n}, {n})")
    if xstar.shape[1] > MAX_D:
        raise ValueError(f"d={xstar.shape[1]} exceeds {MAX_D}; use "
                         "gp.predict_fast")
    if xstar.device.type == "cpu" and x.device.type == "cpu":
        return corr_quad_plain(xstar, x, delta, w_tri)
    xs, xt = _scaled(xstar, x, delta)
    w = w_tri.to(torch.float32).contiguous()
    _check_cuda("corr_quad", xs, xt, w)
    m, d = xs.shape
    quad = torch.zeros((m,), dtype=torch.float32, device=xs.device)
    if m and n:
        if quad_precision == "high":
            err = _launch_quad_tf32x3(xs, xt, w, quad)
        else:
            err = _launch_quad_fp32(xs, xt, w, quad)
        _build.check(err, _QUAD_SOURCE, f"corr_quad ({quad_precision})")
        corr_quad.launches += 1
    return quad


corr_quad.launches = 0


@fp32_exact
def serve_mean(pred, x, xstar, hstar, *,
               rhs_precision: str = "highest") -> torch.Tensor:
    """Posterior mean at xstar through K3 (`serve_mean_pallas`).

    `pred` is a gp.Predictor; equal to gp.predict_fast(...)[0] without the
    (m, n) intermediate.
    """
    ce = corr_matvec(xstar, x, torch.exp(pred.params.log_delta), pred.e,
                     rhs_precision=rhs_precision)
    return hstar.to(torch.float32) @ pred.beta.to(torch.float32) + ce


def _chunks(m: int, batch: int):
    return [(s, min(s + batch, m)) for s in range(0, m, batch)]


def serve_mean_batched(pred, x, xstar, hstar, *, batch: int = 131072,
                       rhs_precision: str = "highest") -> torch.Tensor:
    """`serve_mean` over query chunks of `batch` rows (`serve_mean_pallas_batched`)."""
    parts = [serve_mean(pred, x, xstar[s:e], hstar[s:e],
                        rhs_precision=rhs_precision)
             for s, e in _chunks(xstar.shape[0], batch)]
    if not parts:
        return torch.zeros((0,), dtype=torch.float32, device=xstar.device)
    return torch.cat(parts)


def serve_predictor(state):
    """Serving state from a gp.FitState: gp.predictor, which carries W = L^-1."""
    return gp.predictor(state)


@fp32_exact
def serve_meanvar(spred, x, xstar, hstar, *,
                  rhs_precision: str = "highest",
                  quad_precision: str = "highest",
                  include_nugget: bool = False):
    """Posterior mean AND variance at xstar via K3 then K4 (`serve_meanvar_pallas`).

    Pass 1 (K3): c @ [e | A^-1 H], the mean contraction and the R-term cross
    product in one rhs slab. Pass 2 (K4): |W c|^2, the A^-1 quadratic in
    whitened triangular form. Equal to gp.predict_fast up to fp32 rounding;
    computed in fp32.
    """
    delta = torch.exp(spred.params.log_delta)
    rhs = torch.cat([spred.e[:, None], spred.ainv_h], dim=1).to(torch.float32)
    slab = corr_matvec(xstar, x, delta, rhs, rhs_precision=rhs_precision)
    ce = slab[:, 0]
    c_ainv_h = slab[:, 1:]
    hstar = hstar.to(torch.float32)
    mean = hstar @ spred.beta.to(torch.float32) + ce
    quad_t = corr_quad(xstar, x, delta, spred.linv,
                       quad_precision=quad_precision)
    r = hstar - c_ainv_h
    rw = r @ spred.w_chol.to(torch.float32)
    quad_r = torch.sum(rw * rw, dim=1)
    prior = 1.0 + (spred.params.nugget.to(torch.float32) if include_nugget
                   else 0.0)
    var = spred.sigma2.to(torch.float32) * torch.clamp(
        prior - quad_t + quad_r, min=0.0)
    return mean, var


def serve_meanvar_batched(spred, x, xstar, hstar, *, batch: int = 65536,
                          rhs_precision: str = "highest",
                          quad_precision: str = "highest",
                          include_nugget: bool = False):
    """`serve_meanvar` over query chunks (`serve_meanvar_pallas_batched`).

    A host loop over chunks of `batch` rows bounds the per-chunk work and
    memory regardless of m.
    """
    means, variances = [], []
    for s, e in _chunks(xstar.shape[0], batch):
        mean, var = serve_meanvar(spred, x, xstar[s:e], hstar[s:e],
                                  rhs_precision=rhs_precision,
                                  quad_precision=quad_precision,
                                  include_nugget=include_nugget)
        means.append(mean)
        variances.append(var)
    if not means:
        empty = torch.zeros((0,), dtype=torch.float32, device=xstar.device)
        return empty, empty
    return torch.cat(means), torch.cat(variances)
