"""Approx-MAC GEMMs: the Hopper kernels, their plain PyTorch twins, and
the config operands.

Counterpart of ``repro.kernels.approx_mac.approx_mac`` (its fused, int
and grouped variants).  All three kernels truncate the operands with the
(depth_a, depth_b, gate, rtn) row of each output column's config block
and multiply-accumulate int8 in int32:

* ``approx_mac_fused_matmul`` quantizes f32 activations in-kernel with a
  per-tensor scale and rescales with ONE f32 multiply by the combined
  ``scale_row`` — float in, float out (every dense GEMM of the LM);
* ``approx_mac_matmul`` takes int8 activations and returns the int32
  accumulator (the paper MLP's GEMMs, ``ops.approx_mac``);
* ``approx_mac_grouped_matmul`` is the fused GEMM over a stacked expert
  bank: E GEMMs in one launch, each expert (and each of its config
  blocks) at its own config, one shared activation scale, and rows past
  each expert's ``group_rows`` count absent (the MoE expert GEMMs,
  ``ops.approx_dense_grouped_pallas``);
* ``approx_mac_grouped_matmul_int`` is the same grouped GEMM with the
  epilogue left out: the int32 accumulators per expert (a row-parallel
  expert bank under a sharding mapping sums them over the ranks before
  the one epilogue multiply).

For CUDA tensors each launches its hand-written kernel in
``csrc/approx_mac.cu`` (built with nvcc at first use into
``build/kernels/`` at the repository root, loaded through ctypes) or
raises; for CPU tensors it runs its ``*_ref`` twin, the same function in
plain PyTorch.  There is no fallback between the two.  All three run
one int8 ``mma.sync`` body with each block holding all of its rows (of
one expert, grouped), tiled and split along K by ``gemm_plan`` or
``grouped_plan`` (host ints only); a fused or grouped GEMM of more than
``SLICE_ROWS`` rows first quantizes x in a kernel of its own (one wrapper
call, one count in ``.launches``).  The grouped kernel reads each expert's
row count on the device and skips the tiles past it, weight bytes
included.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core.approx_multiplier import OPERAND_PARAM_TABLE
from repro_torch.core.approx_matmul import exact_int_matmul
from repro_torch.core.quantization import QMAX, truncate_operand_lsb
from repro_torch.kernels import build as _build

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "approx_mac.cu"
KERNEL_BN = 32          # the column granularity: N is padded to it and
#                         config blocks are multiples of it
SMS = 132               # H100 SXM streaming multiprocessors
MAX_SPLITS = 16         # a tile's K splits form one thread block cluster
SPLIT_BLOCKS = 4 * SMS  # K is split towards this many blocks ...
SPLIT_MIN_K = 256       # ... in slices of 4 or more 64-row stages, except
#                         where shorter ones are needed to fill the SMs
GROUPED_SPLIT_BLOCKS = 2 * SMS  # the grouped GEMMs' target: at decode a
#                         split's cluster sum costs more than its blocks gain
SLICE_ROWS = 16         # GEMMs of this many rows or fewer keep each
SLICE_BYTES = 24 * 1024  # block's rows of its K slice in shared memory;
#                         fused and grouped GEMMs of more rows quantize x
#                         once, in a kernel of their own, into an int8
#                         scratch


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/approx_mac.cu (see ``kernels.build``)."""
    return _build.build(_CSRC)


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.approx_mac_fused_matmul
    fn.argtypes = ([ptr] * 5 + [i32, i32] + [ptr] * 2 + [i32] * 7 + [ptr])
    fn.restype = i32
    fn = lib.approx_mac_matmul
    fn.argtypes = ([ptr] * 3 + [i32, i32, ptr] + [i32] * 7 + [ptr])
    fn.restype = i32
    fn = lib.approx_mac_grouped_matmul
    fn.argtypes = ([ptr] * 6 + [i32] * 3 + [ptr] * 2 + [i32] * 8 + [ptr])
    fn.restype = i32
    fn = lib.approx_mac_grouped_matmul_int
    fn.argtypes = ([ptr] * 5 + [i32] * 3 + [ptr] * 2 + [i32] * 8 + [ptr])
    fn.restype = i32
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_target(count: int, m: int, k: int,
                  blocks: int = SPLIT_BLOCKS) -> int:
    """The K splits ``count`` (M, N) tiles of an (m, k) GEMM ask for (see
    ``gemm_plan``; towards `blocks` blocks), before they are capped and
    cut into slices."""
    splits = 1
    if count < blocks:
        splits = max(_cdiv(SMS, count),
                     min(_cdiv(blocks, count), k // SPLIT_MIN_K))
    if m <= SLICE_ROWS:
        splits = max(splits, _cdiv(k, SLICE_BYTES // m // 128 * 128 - 128))
    return splits


@functools.lru_cache(maxsize=1024)
def gemm_plan(m: int, k: int, n: int) -> tuple[int, int, int, int, int]:
    """The tiling of one fused or int GEMM of (m, k) x (k, n) (n a multiple
    of 32): (mt, nt, warps_n, kslice, splits).  A block of 8 warps owns
    (8 // warps_n) * mt * 16 rows and warps_n * nt * 8 columns.  Where the
    (M, N) tiles are fewer than ``SPLIT_BLOCKS``, K is cut into `splits`
    slices of `kslice` (a multiple of 32; the last may be shorter): towards
    SPLIT_BLOCKS blocks in slices of at least ``SPLIT_MIN_K`` (so that the
    last wave is short), in shorter ones where that is what it takes to
    reach SMS blocks, and, at M <= SLICE_ROWS (where a block keeps its
    rows' whole slice in shared memory), in slices whose rows take at most
    ``SLICE_BYTES``; never into more than ``MAX_SPLITS`` (one cluster).
    Host ints only, so a captured call replays the same launch."""
    def tiles(mt, nt, wn):
        return _cdiv(m, (8 // wn) * mt * 16) * _cdiv(n, wn * nt * 8)

    if m > 64:                       # 128 x 128 tiles; narrow GEMMs
        mt, nt, wn = ((1, 2, 4) if n <= 32 else (2, 2, 4) if n <= 64
                      else (4, 4, 4))
    else:                            # all rows in one tile, 128 columns,
        for nt, wn in ((2, 8), (2, 4), (2, 2), (1, 2)):   # or narrower
            mt = _cdiv(_cdiv(m, 16), 8 // wn)   # where K is too short to
            if tiles(mt, nt, wn) * min(k // 128, MAX_SPLITS) >= SMS:
                break                           # fill the SMs by splitting
    splits = _split_target(tiles(mt, nt, wn), m, k)
    if splits <= 1:
        return mt, nt, wn, _cdiv(k, 32) * 32, 1
    kslice = max(32, k // splits // 32 * 32)
    if _cdiv(k, kslice) > MAX_SPLITS:
        kslice = _cdiv(_cdiv(k, MAX_SPLITS), 32) * 32
    return mt, nt, wn, kslice, _cdiv(k, kslice)


@functools.lru_cache(maxsize=1024)
def grouped_plan(e: int, m: int, k: int, n: int
                 ) -> tuple[int, int, int, int, int]:
    """The tiling of one grouped GEMM of e experts' (m, k) x (k, n) (n a
    multiple of 32): (mt, nt, warps_n, kslice, splits), as ``gemm_plan``'s.
    At m <= 64 one block holds all of an expert's rows (mt = ceil(m / 16),
    8 warps across 128 columns), so a touched bank is read once; above,
    128 x 128 tiles, so a bank is read ceil(m / 128) times.  Which experts
    hold rows is device data the plan never reads (a captured call replays
    with new routing), so it counts min(e, m) of them as touched — at a
    dropless decode m = tokens x top-k rows bound the experts that hold
    one — and splits K, by ``gemm_plan``'s rule but towards
    ``GROUPED_SPLIT_BLOCKS``, where their tiles are too few to fill the
    SMs, into at most ``MAX_SPLITS`` slices of equal 32-row multiples (the
    last may be shorter).  Host ints only."""
    mt, nt, wn = (4, 4, 4) if m > 64 else (_cdiv(m, 16), 2, 8)
    bm, bn = (8 // wn) * mt * 16, wn * nt * 8
    count = min(e, m) * _cdiv(m, bm) * _cdiv(n, bn)
    splits = min(_split_target(count, m, k, GROUPED_SPLIT_BLOCKS),
                 MAX_SPLITS)
    kslice = _cdiv(_cdiv(k, splits), 32) * 32
    return mt, nt, wn, kslice, _cdiv(k, kslice)


@functools.cache
def operand_param_table(device: torch.device) -> torch.Tensor:
    """(32, 4) int32 OPERAND_PARAM_TABLE, uploaded once per device."""
    return torch.tensor(OPERAND_PARAM_TABLE, device=device)


def config_operand(config, n_blocks: int, device) -> torch.Tensor:
    """(n_blocks, 4) int32 config rows on `device`, gathered from the
    per-device OPERAND_PARAM_TABLE — for a Python int or 0-d tensor (one
    config broadcast over every block, as a stride-0 view) or an exactly
    (n_blocks,) per-block vector.  Neuron-group vectors of another
    length are mapped onto blocks by ``ops._expand_group_vector``."""
    table = operand_param_table(torch.device(device))
    cfg = torch.as_tensor(config, dtype=torch.long, device=table.device)
    # index_select, not table[cfg]: indexing with a 0-d tensor reads it
    # on the host (a device sync per GEMM)
    if cfg.ndim == 0:
        return table.index_select(0, cfg.reshape(1)).expand(n_blocks, 4)
    if cfg.shape != (n_blocks,):
        raise ValueError(f"config vector {tuple(cfg.shape)} != "
                         f"({n_blocks},) blocks")
    return table.index_select(0, cfg)


def grouped_config_operand(config, n_experts: int, n_blocks: int,
                           device) -> torch.Tensor:
    """(E, n_blocks, 4) int32 config rows of the grouped kernel on
    `device`, gathered from the per-device OPERAND_PARAM_TABLE — for a
    Python int or 0-d tensor (one config for every expert and block), an
    (E,) per-expert vector or an (E, n_blocks) per-expert-per-block
    matrix.  Broadcasts are stride-0 views; per-expert neuron-group
    matrices of another width are mapped onto blocks by
    ``ops._expand_group_vector``."""
    table = operand_param_table(torch.device(device))
    cfg = torch.as_tensor(config, dtype=torch.long, device=table.device)
    if cfg.ndim == 0:
        return table.index_select(0, cfg.reshape(1)).expand(
            n_experts, n_blocks, 4)
    if cfg.ndim == 1 and cfg.shape == (n_experts,):
        return table.index_select(0, cfg)[:, None].expand(
            n_experts, n_blocks, 4)
    if cfg.shape != (n_experts, n_blocks):
        raise ValueError(f"config {tuple(cfg.shape)} for {n_experts} "
                         f"experts x {n_blocks} blocks")
    return table.index_select(0, cfg.reshape(-1)).reshape(
        n_experts, n_blocks, 4)


def _blocked_int_matmul(a_q, w_q, cfg_rows, cfg_bn: int) -> torch.Tensor:
    """Plain int32 product of int8 a_q (M, K) and w_q (K, N), both
    operands truncated with the config row of each output column's
    block; exact accumulation (float64, see core.approx_matmul).  Each
    block's truncation is tabulated once over the 256 int8 values
    (``truncate_operand_lsb`` on every value) and gathered, which is the
    same map as applying it elementwise."""
    m = a_q.shape[0]
    n = w_q.shape[1]
    n_blocks = cfg_rows.shape[0]
    rows = cfg_rows.to(torch.int32)
    values = torch.arange(-128, 128, device=a_q.device).to(torch.int8)[None]
    lut_a = truncate_operand_lsb(values, rows[:, 0:1], rows[:, 2:3],
                                 rows[:, 3:4])           # (nb, 256)
    lut_w = truncate_operand_lsb(values, rows[:, 1:2], rows[:, 2:3],
                                 rows[:, 3:4])
    # activations: one truncated copy per config block -> (nb, M, K)
    a = lut_a[:, a_q.to(torch.int64) + 128]
    # weights: each column through its block's table -> (nb, K, bn)
    wpad = torch.nn.functional.pad(w_q, (0, n_blocks * cfg_bn - n))
    wpad = wpad.reshape(-1, n_blocks, cfg_bn).permute(1, 0, 2)
    offset = torch.arange(0, 256 * n_blocks, 256, device=w_q.device)
    b = lut_w.reshape(-1).take(wpad.to(torch.int64)
                               + (offset + 128)[:, None, None])
    return exact_int_matmul(a, b).permute(1, 0, 2).reshape(m, -1)[:, :n]


def approx_mac_fused_matmul_ref(x, w_q, scale_row, x_scale, cfg_rows,
                                cfg_bn: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (same arguments as
    ``approx_mac_fused_matmul``): quantize, truncate per config block,
    accumulate exactly, one f32 epilogue multiply."""
    x_q = torch.clamp(torch.round(x / x_scale), -QMAX, QMAX).to(torch.int8)
    acc = _blocked_int_matmul(x_q, w_q, cfg_rows, cfg_bn)
    return acc.to(torch.float32) * scale_row.reshape(1, -1)


def approx_mac_matmul_ref(a, w_q, cfg_rows, cfg_bn: int = 128
                          ) -> torch.Tensor:
    """Plain PyTorch version of the int kernel (same arguments as
    ``approx_mac_matmul``): the blocked operand-truncation matmul of
    ``repro.kernels.approx_mac.ref.approx_mac_matmul_ref`` with one
    config row per output block."""
    return _blocked_int_matmul(a, w_q, cfg_rows, cfg_bn)


def approx_mac_grouped_matmul_ref(x, w_q, scale_rows, x_scale, group_rows,
                                  cfg_rows, cfg_bn: int = 128
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernel (same arguments as
    ``approx_mac_grouped_matmul``): expert by expert the fused plain
    GEMM on the shared x_scale, with rows past group_rows[e] absent
    (zero outputs)."""
    e, m, _ = x.shape
    x_q = torch.clamp(torch.round(x / x_scale), -QMAX, QMAX).to(torch.int8)
    outs = [_blocked_int_matmul(x_q[i], w_q[i], cfg_rows[i], cfg_bn)
            .to(torch.float32) * scale_rows[i].reshape(1, -1)
            for i in range(e)]
    present = (torch.arange(m, device=x.device)[None, :]
               < group_rows.reshape(e, 1))[..., None]
    return torch.where(present, torch.stack(outs), 0.0)


def approx_mac_grouped_matmul_int_ref(x, w_q, x_scale, group_rows,
                                      cfg_rows, cfg_bn: int = 128
                                      ) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernel's int32-out instance
    (same arguments as ``approx_mac_grouped_matmul_int``): expert by
    expert the blocked int product of x quantized at the shared x_scale,
    no epilogue, rows past group_rows[e] absent (zeros)."""
    e, m, _ = x.shape
    x_q = torch.clamp(torch.round(x / x_scale), -QMAX, QMAX).to(torch.int8)
    outs = [_blocked_int_matmul(x_q[i], w_q[i], cfg_rows[i], cfg_bn)
            for i in range(e)]
    present = (torch.arange(m, device=x.device)[None, :]
               < group_rows.reshape(e, 1))[..., None]
    return torch.where(present, torch.stack(outs), 0)


def _check_operands(a, w_q, cfg_rows, cfg_bn: int) -> None:
    """The launch contract both kernels share (shapes, devices, rows)."""
    k, n = w_q.shape
    if w_q.dtype != torch.int8 or a.shape[1] != k:
        raise ValueError(f"shapes a {tuple(a.shape)}, w {tuple(w_q.shape)} "
                         f"({w_q.dtype})")
    if cfg_bn % KERNEL_BN or cfg_rows.shape != (-(-n // cfg_bn), 4):
        raise ValueError(f"cfg_rows {tuple(cfg_rows.shape)} for N={n}, "
                         f"cfg_bn={cfg_bn}")
    for t in (w_q, cfg_rows):
        if t.device != a.device:
            raise ValueError(f"tensor on {t.device}, expected {a.device}")
    if cfg_rows.dtype != torch.int32 or cfg_rows.stride(1) != 1:
        raise ValueError("cfg_rows must be int32 with unit column stride")


def _padded_weight(w_q, align: int = 16) -> tuple[torch.Tensor, int]:
    """The kernels take whole 32-column tiles: ragged N (the last dim of
    a (K, N) matrix or an (E, K, N) bank) is padded with zero columns
    (zero weights change no kept result)."""
    pad = (-w_q.shape[-1]) % KERNEL_BN
    w = w_q.contiguous()
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    if w.data_ptr() % align:
        raise ValueError(f"weight rows must be {align}-byte aligned")
    return w, pad


def approx_mac_fused_matmul(x, w_q, scale_row, x_scale, cfg_rows,
                            cfg_bn: int = 128) -> torch.Tensor:
    """x: (M, K) f32; w_q: (K, N) int8; scale_row: (N,) f32 COMBINED
    dequant scales x_scale * w_scale (rounded once by the caller);
    x_scale: (1,) or 0-d f32 per-tensor activation scale; cfg_rows:
    (ceil(N / cfg_bn), 4) int32 config rows (``config_operand``), row i
    governing output columns [i*cfg_bn, (i+1)*cfg_bn).  Returns (M, N)
    f32.  CUDA tensors launch the kernel (counted in ``.launches``) or
    raise; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return approx_mac_fused_matmul_ref(x, w_q, scale_row, x_scale,
                                           cfg_rows, cfg_bn)
    if x.device.type != "cuda":
        raise ValueError(f"no approx-MAC kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"need f32 x, got {x.dtype}")
    _build.refuse_grad("approx_mac_fused_matmul", x, scale_row, x_scale)
    _check_operands(x, w_q, cfg_rows, cfg_bn)
    m, k = x.shape
    n = w_q.shape[1]
    if scale_row.numel() != n or scale_row.device != x.device \
            or x_scale.device != x.device:
        raise ValueError(f"scale_row {tuple(scale_row.shape)} on "
                         f"{scale_row.device} for N={n}")
    x = x.contiguous()
    w, pad = _padded_weight(w_q)
    srow = scale_row.reshape(n).float().contiguous()
    if pad:
        srow = torch.nn.functional.pad(srow, (0, pad))
    xs = x_scale.reshape(1).float().contiguous()
    out = torch.empty((m, n + pad), dtype=torch.float32, device=x.device)
    mt, nt, wn, kslice, _ = gemm_plan(m, k, n + pad)
    xq = (torch.empty((m, k), dtype=torch.int8, device=x.device)
          if m > SLICE_ROWS else None)
    err = _lib().approx_mac_fused_matmul(
        x.data_ptr(), w.data_ptr(), srow.data_ptr(), xs.data_ptr(),
        cfg_rows.data_ptr(), cfg_rows.stride(0), cfg_bn, out.data_ptr(),
        xq.data_ptr() if xq is not None else None, m, k, n + pad, mt, nt, wn,
        kslice, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"approx_mac_fused_matmul launch failed: CUDA "
                           f"error {err}")
    approx_mac_fused_matmul.launches += 1
    return out[:, :n] if pad else out


approx_mac_fused_matmul.launches = 0


def approx_mac_matmul(a, w_q, cfg_rows, cfg_bn: int = 128) -> torch.Tensor:
    """a: (M, K) int8; w_q: (K, N) int8; cfg_rows: (ceil(N / cfg_bn), 4)
    int32 config rows (``config_operand``).  Returns (M, N) int32, the
    truncated operands' exact products summed.  CUDA tensors launch the
    kernel (counted in ``.launches``) or raise; CPU tensors take the
    plain version."""
    if a.device.type == "cpu":
        return approx_mac_matmul_ref(a, w_q, cfg_rows, cfg_bn)
    if a.device.type != "cuda":
        raise ValueError(f"no approx-MAC kernel for device {a.device}")
    if a.dtype != torch.int8:
        raise TypeError(f"need int8 activations, got {a.dtype}")
    _check_operands(a, w_q, cfg_rows, cfg_bn)
    m, k = a.shape
    n = w_q.shape[1]
    a = a.contiguous()
    w, pad = _padded_weight(w_q)
    out = torch.empty((m, n + pad), dtype=torch.int32, device=a.device)
    mt, nt, wn, kslice, _ = gemm_plan(m, k, n + pad)
    err = _lib().approx_mac_matmul(
        a.data_ptr(), w.data_ptr(), cfg_rows.data_ptr(), cfg_rows.stride(0),
        cfg_bn, out.data_ptr(), m, k, n + pad, mt, nt, wn, kslice,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"approx_mac_matmul launch failed: CUDA error "
                           f"{err}")
    approx_mac_matmul.launches += 1
    return out[:, :n] if pad else out


approx_mac_matmul.launches = 0


def _check_grouped(x, w_q, scale_rows, x_scale, group_rows, cfg_rows,
                   cfg_bn: int) -> None:
    """The launch contract both grouped instances share (scale_rows
    None for the int32-out one)."""
    if x.dtype != torch.float32 or w_q.dtype != torch.int8:
        raise TypeError(f"need f32 x and int8 w, got {x.dtype}, "
                        f"{w_q.dtype}")
    e, m, k = x.shape
    n = w_q.shape[2]
    n_blocks = -(-n // cfg_bn)
    if w_q.shape[:2] != (e, k) or group_rows.shape != (e,) \
            or (scale_rows is not None and scale_rows.shape != (e, n)) \
            or cfg_rows.shape != (e, n_blocks, 4) or cfg_bn % KERNEL_BN:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w_q.shape)},"
                         f" group_rows {tuple(group_rows.shape)}, cfg_rows "
                         f"{tuple(cfg_rows.shape)} (cfg_bn {cfg_bn})")
    for t in (w_q, scale_rows, x_scale, group_rows, cfg_rows):
        if t is not None and t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
    if cfg_rows.dtype != torch.int32 or cfg_rows.stride(2) != 1 \
            or group_rows.dtype != torch.int32:
        raise ValueError("cfg_rows and group_rows must be int32, cfg_rows "
                         "with unit last stride")


def approx_mac_grouped_matmul(x, w_q, scale_rows, x_scale, group_rows,
                              cfg_rows, cfg_bn: int = 128) -> torch.Tensor:
    """x: (E, M, K) f32 per-expert activation slices; w_q: (E, K, N) int8
    stacked bank; scale_rows: (E, N) f32 COMBINED dequant scales
    x_scale * w_scale[e] (rounded once by the caller); x_scale: (1,) or
    0-d f32 activation scale shared by every expert; group_rows: (E,)
    int32 rows present per expert (rows at index >= group_rows[e] give
    zeros); cfg_rows: (E, ceil(N / cfg_bn), 4) int32 config rows
    (``grouped_config_operand``).  Returns (E, M, N) f32.  CUDA tensors
    launch the kernel (counted in ``.launches``; at M > ``SLICE_ROWS`` a
    quantize kernel runs first, in the same count) or raise; CPU tensors
    take the plain version."""
    if x.device.type == "cpu":
        return approx_mac_grouped_matmul_ref(x, w_q, scale_rows, x_scale,
                                             group_rows, cfg_rows, cfg_bn)
    if x.device.type != "cuda":
        raise ValueError(f"no approx-MAC kernel for device {x.device}")
    _build.refuse_grad("approx_mac_grouped_matmul", x, scale_rows, x_scale)
    _check_grouped(x, w_q, scale_rows, x_scale, group_rows, cfg_rows, cfg_bn)
    e, m, k = x.shape
    n = w_q.shape[2]
    w, pad = _padded_weight(w_q)
    srow = scale_rows.float().contiguous()
    if pad:
        srow = torch.nn.functional.pad(srow, (0, pad))
    x = x.contiguous()
    rows = group_rows.contiguous()
    xs = x_scale.reshape(1).float().contiguous()
    out = torch.empty((e, m, n + pad), dtype=torch.float32, device=x.device)
    mt, nt, wn, kslice, _ = grouped_plan(e, m, k, n + pad)
    xq = (torch.empty((e, m, k), dtype=torch.int8, device=x.device)
          if m > SLICE_ROWS else None)
    err = _lib().approx_mac_grouped_matmul(
        x.data_ptr(), w.data_ptr(), srow.data_ptr(), xs.data_ptr(),
        rows.data_ptr(), cfg_rows.data_ptr(), cfg_rows.stride(0),
        cfg_rows.stride(1), cfg_bn, out.data_ptr(),
        xq.data_ptr() if xq is not None else None, e, m, k, n + pad, mt, nt,
        wn, kslice, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"approx_mac_grouped_matmul launch failed: CUDA "
                           f"error {err}")
    approx_mac_grouped_matmul.launches += 1
    return out[..., :n] if pad else out


approx_mac_grouped_matmul.launches = 0


def approx_mac_grouped_matmul_int(x, w_q, x_scale, group_rows, cfg_rows,
                                  cfg_bn: int = 128) -> torch.Tensor:
    """The grouped GEMM without its epilogue: x (E, M, K) f32 quantized
    at the shared x_scale ((1,) or 0-d f32), w_q (E, K, N) int8,
    group_rows (E,) int32, cfg_rows (E, ceil(N / cfg_bn), 4) int32 as
    for ``approx_mac_grouped_matmul``.  Returns (E, M, N) int32, the
    truncated operands' exact products summed, zeros in absent rows.
    CUDA tensors launch the grouped kernel's int32-out instance (counted
    in ``.launches``; at M > ``SLICE_ROWS`` a quantize kernel runs
    first, in the same count) or raise; CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return approx_mac_grouped_matmul_int_ref(x, w_q, x_scale,
                                                 group_rows, cfg_rows, cfg_bn)
    if x.device.type != "cuda":
        raise ValueError(f"no approx-MAC kernel for device {x.device}")
    _build.refuse_grad("approx_mac_grouped_matmul_int", x, x_scale)
    _check_grouped(x, w_q, None, x_scale, group_rows, cfg_rows, cfg_bn)
    e, m, k = x.shape
    n = w_q.shape[2]
    w, pad = _padded_weight(w_q)
    x = x.contiguous()
    rows = group_rows.contiguous()
    xs = x_scale.reshape(1).float().contiguous()
    out = torch.empty((e, m, n + pad), dtype=torch.int32, device=x.device)
    mt, nt, wn, kslice, _ = grouped_plan(e, m, k, n + pad)
    xq = (torch.empty((e, m, k), dtype=torch.int8, device=x.device)
          if m > SLICE_ROWS else None)
    err = _lib().approx_mac_grouped_matmul_int(
        x.data_ptr(), w.data_ptr(), xs.data_ptr(), rows.data_ptr(),
        cfg_rows.data_ptr(), cfg_rows.stride(0), cfg_rows.stride(1), cfg_bn,
        out.data_ptr(), xq.data_ptr() if xq is not None else None, e, m, k,
        n + pad, mt, nt, wn, kslice,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"approx_mac_grouped_matmul_int launch failed: "
                           f"CUDA error {err}")
    approx_mac_grouped_matmul_int.launches += 1
    return out[..., :n] if pad else out


approx_mac_grouped_matmul_int.launches = 0
