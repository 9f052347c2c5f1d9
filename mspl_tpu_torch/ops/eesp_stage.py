"""Fused eval EESP stage: the CUDA kernel of `csrc/eesp_stage.cu`, its plain
PyTorch version, and `eesp_block_params`, which folds one port `EESP`
unit's BatchNorms into the arrays both take.

Replaces mspl_tpu/ops/pallas_eesp_stage.py::eesp_stage_fused_eval: a chain
of stride-1 eval EESP units, each grouped 1x1 proj (BN folded) + bias +
PReLU -> K dilated depthwise 3x3 + HFF -> BR affine + PReLU -> grouped (or
dense) 1x1 expand (BN folded) + bias -> residual -> PReLU.  The kernel runs
one launch per unit, so a stage of U units is U launches (3 for level3, 7
for level4 of ESPNetv2).  The TPU kernel's layout and VMEM devices
(`padded_io`, `lane_pack`, `images_per_step`, `max_blocks`) change no
number and have no counterpart.

Both the kernel and the plain version round the proj output and the unit
output to the working dtype and keep everything between in f32.  The
kernel computes the two 1x1 products on the tensor cores as split bf16
(each operand a as hi = bf16(a) plus lo = bf16(a - hi), products hi.hi +
lo.hi + hi.lo accumulated in f32), which keeps that f32 contract; the
weights' hi and lo are packed once per unit by `_pack`, and `_tiling`
models the kernel's shared memory.  The
per-unit arrays are cached on the unit and rebuilt when any of its
parameters or statistics changes (the cache is keyed on each tensor's
storage and `_version`, which in-place loads such as `load_flax_variables`
and `load_state_dict` bump).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from mspl_tpu_torch.ops import _cuda
from mspl_tpu_torch.ops.eesp_branches import MAX_K, _stack_plain

SMEM_BYTES = 227 * 1024  # a block's dynamic shared memory on the H100
_DTYPES = (torch.float32, torch.bfloat16)


def _dense_1x1(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """Grouped 1x1 OIHW weight [Cout, Cin/G, 1, 1] -> dense block-diagonal
    [Cin, Cout] (input-major, as the JAX package's `_dense_1x1`)."""
    cout, cin_g = weight.shape[:2]
    wg = weight[:, :, 0, 0].reshape(groups, cout // groups, cin_g)
    return torch.block_diag(*[g.t() for g in wg])


def _fold(unit) -> Dict[str, torch.Tensor]:
    k = len(unit.dilations)
    pconv = unit.proj_1x1.cb.conv.conv.weight          # [n, C/Gp, 1, 1]
    n = pconv.shape[0]
    c = n * k
    g_proj = c // pconv.shape[1]
    pa, pb = unit.proj_1x1.cb.bn.eval_affine()
    # [K*9, n]: branch-major, row-major 3x3 taps
    taps = torch.cat([wk[:, 0].reshape(n, 9).t() for wk in unit.dw])
    ca, cb = unit.br_after_cat.bn.eval_affine()
    cstack = torch.stack([ca, cb, unit.br_after_cat.act.alpha])     # [3, C]
    econv = unit.conv_1x1_exp.conv.conv.weight         # [C, C/Ge, 1, 1]
    g_exp = c // econv.shape[1]
    ea, eb = unit.conv_1x1_exp.bn.eval_affine()
    if g_exp == k:
        # grouped expand: input group g of the 1x1 is branch g
        ew = (econv[:, :, 0, 0].reshape(k, n, n).transpose(1, 2)
              * ea.reshape(k, 1, n))                    # [K, n_in, n_out]
        cataff = cstack.reshape(3, k, n).permute(1, 0, 2)  # [K, 3, n]
    else:
        ew = _dense_1x1(econv, g_exp) * ea[None, :]    # [C, C]
        cataff = cstack[None]                           # [1, 3, C]
    return {
        "pw": _dense_1x1(pconv, g_proj) * pa[None, :],
        "paff": torch.stack([pb, unit.proj_1x1.act.alpha]),
        "taps": taps,
        "cataff": cataff.contiguous(),
        "ew": ew.contiguous(),
        "eaff": eb[None, :],
        "alpha": unit.module_act.alpha.detach().clone(),
        "g_proj": g_proj,
    }


def eesp_block_params(unit) -> Dict[str, torch.Tensor]:
    """One stride-1 port `EESP` unit's fused-stage arrays (the JAX package's
    `eesp_block_params` contract, BN scales folded into the 1x1 weights):
    pw [C, n], paff [2, n] (bias, PReLU alpha), taps [K*9, n], cataff
    [K, 3, n] (grouped expand) or [1, 3, C], ew [K, n, n] or [C, C],
    eaff [1, C], alpha [C], plus `g_proj`, the proj's group count.  Cached
    on the unit until one of its tensors changes."""
    key = tuple((t.data_ptr(), t._version, t.device, t.dtype)
                for t in itertools.chain(unit.parameters(), unit.buffers()))
    hit = getattr(unit, "_fused_params", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        params = _fold(unit)
    unit._fused_params = (key, params)
    return params


def _grouped(blk) -> bool:
    return blk["ew"].dim() == 3


def _unit_plain(x: torch.Tensor, blk, dilations: Sequence[int]):
    f32 = torch.float32
    xf = x.to(f32)
    k = len(dilations)
    n = x.shape[1] // k
    paff = blk["paff"].to(f32)
    y = torch.einsum("bchw,cn->bnhw", xf, blk["pw"].to(f32))
    y = F.prelu(y + paff[0].view(1, -1, 1, 1), paff[1]).to(x.dtype).to(f32)
    z = _stack_plain(y, blk["taps"].to(f32).reshape(k, 3, 3, n), dilations, 1)
    cat = blk["cataff"].to(f32)
    cat = (cat.permute(1, 0, 2).reshape(3, -1) if _grouped(blk) else cat[0])
    z = F.prelu(z * cat[0].view(1, -1, 1, 1) + cat[1].view(1, -1, 1, 1),
                cat[2])
    ew = blk["ew"].to(f32)
    if _grouped(blk):
        e = torch.cat([torch.einsum("bihw,io->bohw", z[:, g * n:(g + 1) * n],
                                    ew[g]) for g in range(k)], dim=1)
    else:
        e = torch.einsum("bihw,io->bohw", z, ew)
    e = e + blk["eaff"].to(f32).view(1, -1, 1, 1) + xf
    return F.prelu(e, blk["alpha"].to(f32)).to(x.dtype)


def eesp_stage_fused_eval_plain(x: torch.Tensor, blocks: List[Dict],
                                dilations: Sequence[int]) -> torch.Tensor:
    """Plain version: x [B, C, H, W] through the chain of units `blocks`
    (each an `eesp_block_params` dict); returns [B, C, H, W] in x.dtype."""
    for blk in blocks:
        x = _unit_plain(x, blk, dilations)
    return x


# shared memory of a block: [z hi | z lo] bf16 [zrows, pc + LD_PAD] | one
# 16x16 f32 scratch tile a warp (16 warps) | y [n, cap] in the working dtype
LD_PAD = 8
SCRATCH_BYTES = 16 * 16 * 16 * 4


class Tiling(NamedTuple):
    th: int      # output rows a block
    cap: int     # halo-band pixels a channel of the staged proj output y
    pc: int      # output pixels a chunk (a multiple of 16)
    pp: int      # halo-band pixels a proj window (a multiple of 16)
    zrows: int   # rows of the staged product operands
    smem: int    # dynamic shared memory bytes a block


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _products(c: int, n: int, k: int, g_proj: int, grouped: bool):
    """(groups, rows, cols) of the two products' padded A operands: proj
    g_proj x [pad16(n/g), pad16(C/g)], expand K x [pad16(n), pad16(n)]
    (grouped) or 1 x [pad16(C), pad16(C)] (dense)."""
    proj = (g_proj, _pad16(n // g_proj), _pad16(c // g_proj))
    exp = (k, _pad16(n), _pad16(n)) if grouped else (1, _pad16(c), _pad16(c))
    return proj, exp


def _smem_bytes(zrows: int, pc: int, n: int, cap: int, itemsize: int) -> int:
    """The dynamic shared memory a launch asks for (csrc/eesp_stage.cu)."""
    return zrows * (pc + LD_PAD) * 4 + SCRATCH_BYTES + n * cap * itemsize


@functools.lru_cache(maxsize=None)
def _tiling(h: int, w: int, n: int, c: int, k: int, dmax: int,
            itemsize: int, g_proj: int, grouped: bool) -> Tiling:
    """The kernel's tiling: the fewest row bands whose staged proj output y
    and a chunk of at least 16 pixels fit a block's shared memory, the
    widest chunk (up to 128 pixels) beside them, and the widest proj window
    whose staged input (bf16 hi, and lo for f32) fits the chunk's z region."""
    proj, exp = _products(c, n, k, g_proj, grouped)
    prows = proj[0] * proj[2]
    zrows = max(prows, exp[0] * exp[2])
    split = 2 if itemsize == 4 else 1
    for bands in range(1, h + 1):
        th = -(-h // bands)
        rows = max(min(h, r0 + th + dmax) - max(0, r0 - dmax)
                   for r0 in range(0, h, th))
        cap = rows * w
        free = SMEM_BYTES - _smem_bytes(zrows, 0, n, cap, itemsize)
        pc = min(128, free // (zrows * 4) // 16 * 16)
        if pc >= 16:
            zbytes = zrows * (pc + LD_PAD) * 4
            pp = (zbytes // (prows * 2 * split) - LD_PAD) // 16 * 16
            return Tiling(th, cap, pc, min(pp, _pad16(cap)), zrows,
                          _smem_bytes(zrows, pc, n, cap, itemsize))
    raise ValueError(f"no tiling of a {h}x{w} plane with n={n}, C={c} fits "
                     "shared memory")


def _operands(blk) -> List[torch.Tensor]:
    """The two products' A operands in f32, output-major and zero-padded
    to 16x16 tiles per group (`_products`): proj [g_proj, n/g, C/g] from
    the diagonal blocks of pw, expand ew transposed."""
    pw = blk["pw"].float()
    g = int(blk.get("g_proj", 1))
    ci, co = pw.shape[0] // g, pw.shape[1] // g
    proj = torch.stack([pw[i * ci:(i + 1) * ci, i * co:(i + 1) * co].t()
                        for i in range(g)])
    ew = blk["ew"].float()
    exp = ew.transpose(1, 2) if ew.dim() == 3 else ew.t()[None]
    return [F.pad(a, (0, _pad16(a.shape[2]) - a.shape[2],
                      0, _pad16(a.shape[1]) - a.shape[1]))
            for a in (proj, exp)]


def _split(a: torch.Tensor):
    """f32 -> bf16 (hi, lo) with hi + lo = a within 2^-16 relative."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.float()).to(torch.bfloat16)


def _pack(blk, device) -> Dict:
    """The kernel's packed parameters of one unit, kept in `blk`: "f32",
    [pb | pa | taps | ca | cb | cal | eb | alpha]; "mma", bf16 [proj hi |
    proj lo | expand hi | expand lo] of `_operands`; "blocks", each mma
    block's (name, offset, shape), every offset a multiple of 16 elements
    (32 bytes, as the tensor cores' loads need)."""
    hit = blk.get("_packed")
    if hit is not None and hit["f32"].device == device:
        return hit
    cat = blk["cataff"]
    cat = cat.permute(1, 0, 2).reshape(3, -1) if _grouped(blk) else cat[0]
    f32 = torch.cat([t.reshape(-1).to(device=device, dtype=torch.float32)
                     for t in (blk["paff"], blk["taps"], cat, blk["eaff"],
                               blk["alpha"])])
    parts, blocks, off = [], [], 0
    for name, a in zip(("proj", "expand"), _operands(blk)):
        for half, t in zip(("hi", "lo"), _split(a.to(device))):
            parts.append(t.reshape(-1))
            blocks.append((f"{name}_{half}", off, tuple(t.shape)))
            off += t.numel()
    hit = {"f32": f32, "mma": torch.cat(parts), "blocks": blocks}
    blk["_packed"] = hit
    return hit


def eesp_stage_fused_eval(x: torch.Tensor, blocks: List[Dict],
                          dilations: Sequence[int]) -> torch.Tensor:
    """Chain of stride-1 eval EESP units: x [B, C, H, W] (f32 or bf16),
    `blocks` a list of `eesp_block_params` dicts -> [B, C, H, W] in
    x.dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel once per unit."""
    if not x.is_cuda:
        return eesp_stage_fused_eval_plain(x, blocks, dilations)
    _cuda.require(x, "x", _DTYPES)
    b, c, h, w = x.shape
    k = len(dilations)
    n = c // k
    if not 1 <= k <= MAX_K or n * k != c or min(dilations) < 1:
        raise ValueError(f"kernel limits: 1..{MAX_K} branches, C = K*n, "
                         "dilations >= 1")
    dil = (ctypes.c_int * k)(*[int(d) for d in dilations])
    lib = _lib()
    bufs = [torch.empty_like(x), torch.empty_like(x) if len(blocks) > 1
            else None]
    cur = x
    for i, blk in enumerate(blocks):
        grouped = _grouped(blk)
        g_proj = int(blk.get("g_proj", 1))
        if tuple(blk["ew"].shape) != ((k, n, n) if grouped else (c, c)):
            raise ValueError(f"expand weights {tuple(blk['ew'].shape)} do not "
                             f"fit C={c}, K={k}")
        if n % g_proj:
            raise ValueError(f"{g_proj} proj groups do not divide n={n}")
        t = _tiling(h, w, n, c, k, max(dilations), x.element_size(), g_proj,
                    grouped)
        prm = _pack(blk, x.device)
        out = bufs[i % 2]
        err = lib.eesp_unit_launch(
            _cuda.ptr(cur), _cuda.ptr(out), _cuda.ptr(prm["f32"]),
            _cuda.ptr(prm["mma"]), 1 if x.dtype == torch.bfloat16 else 0, b,
            c, n, k, h, w, g_proj, int(grouped), t.th, t.pc, t.pp, t.cap,
            t.zrows, t.smem, dil, _cuda.stream(x))
        _cuda.check(lib, err, "eesp_unit_launch")
        eesp_stage_fused_eval.launches += 1
        cur = out
    return cur


eesp_stage_fused_eval.launches = 0


def _lib():
    lib = _cuda.load("eesp_stage")
    fn = lib.eesp_unit_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [ci] * 15 + [ctypes.POINTER(ci), vp]
        fn.restype = ci
    return lib
