"""K2: fused multi-head window attention with SAM's decomposed rel-pos.

Counterpart of wsinsight_tpu/ops/flash_attn.py; both CUDA kernels replace the
TPU kernel built by ``_make_kernel`` there (``flash_attn.py:87``, launched at
``:195``). They live in ``csrc/window_attention.cu``, whose header states
their bounds and designs; ``window_attention_reference`` is the plain torch
version of the same contract. ``window_attention`` dispatches on where the
qkv grid lies: a CUDA tensor goes to a kernel (or raises), a CPU tensor to
the plain version. Nothing else.

* float32: QKᵀ, PV and the rel-pos dot products as 3×TF32 tensor-core
  products, ``mma.sync`` m16n8k8 tf32 with f32 accumulators
  (``window_attention_kernel_tf32``): each operand split into a TF32 hi and
  lo part, each product ``lo·hi + hi·lo + hi·hi`` (about 22 bits), held to
  the f32 bar. Single-pass TF32 is not used: parity runs with TF32 off. It
  computes only the real rows (``valid``); bound by bytes at CellViT-SAM-H's
  windowed shape, B=32, with valid=(16, 16) (102 µs: 341 MB at an H100
  SXM's 3.35 TB/s; 53 µs of operations at 494.7 TFLOP/s of dense TF32).
* bfloat16: QKᵀ, PV and the rel-pos dot products as bf16 tensor-core
  products, ``mma.sync`` m16n8k16 with f32 accumulators
  (``window_attention_kernel_mma``); bound by bytes (76.7 µs at the same
  shape: 257 MB at 3.35 TB/s). So it keeps q, K, V and P in bf16: q as
  register fragments, K and V as bf16 shared-memory tiles (double-buffered by
  ``cp.async``), P converted in registers from the score accumulators; 128
  query rows per CTA, so a window's K and V are staged once per 128 rows.

Contract (the TPU kernel's, ``flash_attn.py:87-125``), per (image, window,
head), with q, k, v the head's slices of the window's tokens (row-major):

* ``S = (q * scale) @ k.T``, ``q * scale`` rounded to q's dtype (the scale
  itself too, as JAX rounds a Python scalar to the array's dtype), the
  products summed in float32;
* with rel-pos, ``S += rel_h[:, kh] + rel_w[:, kw]`` where
  ``rel_h[(qh, qw), kh] = q[(qh, qw)] . Rh[qh, kh]`` (q unscaled) and
  likewise ``rel_w``, each rounded to q's dtype before the add;
* a float32 softmax over the keys, P cast to v's dtype, ``P @ v`` summed in
  float32, the result in the input dtype.

Pad tokens of a padded window carry the qkv bias and take part in the
attention, as in SAM: nothing is masked.

Real rows: ``valid=(h, w)`` is the real token extent of a padded grid (the
model crops the output to ``[:h, :w]``). Each output row depends only on its
own q and on all the keys, pad keys included, so the float32 kernel computes
only the rows of real tokens and leaves the others unwritten
(``torch.empty``); every real row is what it is at full rows. The plain
version returns NaN there; the bfloat16 kernel computes every row. It
defaults to the whole grid; global attention takes only the whole grid.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library

_SOURCE = "window_attention.cu"
_HEAD_DIMS = (32, 64, 80, 128)  # the kernel's instantiations
_SMEM_MAX = 227 * 1024
# (query rows per CTA, keys per staged tile): bf16 8 warps of one m16 tile
# and 64 keys; float32 4 warps and 32 keys (see the .cu).
_CTA = {torch.bfloat16: (128, 64), torch.float32: (64, 32)}


def _geometry(shape: torch.Size, num_heads: int, window: int):
    """(dim, hd, ah, aw, gh, gw) of a (B, HP, WP, 3*dim) qkv grid."""
    _, hp, wp, c3 = shape
    if c3 % 3 or (c3 // 3) % num_heads:
        raise ValueError(f"window_attention: {c3} channels do not split into 3 x {num_heads} heads")
    dim = c3 // 3
    if window:
        if hp % window or wp % window:
            raise ValueError(f"window_attention: grid {hp}x{wp} is not a multiple of window {window}")
        return dim, dim // num_heads, window, window, hp // window, wp // window
    return dim, dim // num_heads, hp, wp, 1, 1


def _rounded_scale(scale: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(scale, dtype=dtype))


def _valid_extent(shape: torch.Size, window: int, valid) -> tuple[int, int]:
    """The checked (h, w) of ``valid``; the whole grid when it is None."""
    _, hp, wp, _ = shape
    if valid is None:
        return hp, wp
    h, w = (int(v) for v in valid)
    if not (0 < h <= hp and 0 < w <= wp):
        raise ValueError(f"window_attention: valid {(h, w)} is not within the {hp}x{wp} grid")
    if not window and (h, w) != (hp, wp):
        raise ValueError("window_attention: global attention takes only the whole grid as valid")
    return h, w


def window_attention_reference(
    qkv: torch.Tensor,
    num_heads: int,
    window: int,
    scale: float,
    rh: torch.Tensor | None = None,
    rw: torch.Tensor | None = None,
    valid: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Plain torch K2: (B, HP, WP, 3*dim) -> (B, HP, WP, dim), unfused,
    with the kernel's roundings (see the module docstring). Rows outside
    ``valid`` are NaN."""
    b, hp, wp, _ = qkv.shape
    dim, hd, ah, aw, gh, gw = _geometry(qkv.shape, num_heads, window)
    h, w = _valid_extent(qkv.shape, window, valid)
    n = ah * aw
    dt = qkv.dtype
    with torch.autocast(qkv.device.type, enabled=False):
        # (B, gh, ah, gw, aw, 3, heads, hd) -> (3, B*nw, heads, n, hd)
        x = qkv.reshape(b, gh, ah, gw, aw, 3, num_heads, hd)
        x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * gh * gw, num_heads, n, hd)
        q, k, v = x[0], x[1], x[2]
        qs = q * torch.tensor(_rounded_scale(scale, dt), dtype=dt)
        s = torch.matmul(qs.float(), k.float().transpose(-1, -2))  # (B*nw, heads, n, n)
        if rh is not None:
            rq = q.float().reshape(-1, num_heads, ah, aw, hd)
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, rh.float()).to(dt).float()
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, rw.float()).to(dt).float()
            s = s.reshape(-1, num_heads, ah, aw, ah, aw)
            s = s + rel_h[..., :, None] + rel_w[..., None, :]
            s = s.reshape(-1, num_heads, n, n)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.matmul(p.float(), v.float()).to(dt)  # (B*nw, heads, n, hd)
        o = o.reshape(b, gh, gw, num_heads, ah, aw, hd).permute(0, 1, 4, 2, 5, 3, 6)
        o = o.reshape(b, hp, wp, dim)
        if (h, w) != (hp, wp):
            o[:, h:] = float("nan")
            o[:, :, w:] = float("nan")
        return o


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind(load_library(_SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from ``_SOURCE``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wsi_window_attention.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32,  # qkv, out, rh, rw, bf16, head dim
        i32, i32, i32, i32, i32,  # B, HP, WP, dim, heads
        i32, i32, i32, i32, ctypes.c_float, ptr,  # ah, aw, gh, gw, scale, stream
    ]
    lib.wsi_window_attention.restype = i32
    if hasattr(lib, "wsi_window_attention_rows"):  # builds before it have only the above
        lib.wsi_window_attention_rows.argtypes = [
            *lib.wsi_window_attention.argtypes[:15], i32, i32, ctypes.c_float, ptr
        ]  # ..., gw, h, w, scale, stream
        lib.wsi_window_attention_rows.restype = i32
    lib.wsi_cuda_error_string.argtypes = [i32]
    lib.wsi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def shared_memory_bytes(hd: int, ah: int, aw: int, with_rel: bool, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA: two stages of K and V tiles and
    the CTA's q rows, and each query row's ah + aw rel values in float32,
    rows of a stride that is 8 mod 32 (``rel_stride`` in the .cu).
    bfloat16: 128 query rows, tiles of 64 keys in rows of hd + 8, q staged in
    the second stage. float32: 64 query rows, tiles of 32 keys in rows of
    hd + 4, q in rows of its own."""
    rows, keys = _CTA[dtype]
    if dtype == torch.bfloat16:
        tiles = 2 * 2 * keys * (hd + 8) * 2
    else:
        tiles = (2 * 2 * keys + rows) * (hd + 4) * 4
    stride = ah + aw + ((8 - (ah + aw)) & 31)
    return tiles + (rows * stride * 4 if with_rel else 0)


def window_attention(
    qkv: torch.Tensor,
    num_heads: int,
    window: int,
    scale: float,
    rh: torch.Tensor | None = None,
    rw: torch.Tensor | None = None,
    valid: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Fused multi-head (windowed) attention over a qkv feature grid.

    qkv: (B, HP, WP, 3*dim), channels [q | k | v], each split into
    ``num_heads`` heads. HP and WP are multiples of ``window``; ``window ==
    0`` means global attention over the whole grid. rh / rw: optional
    expanded rel-pos tables (ah, ah, hd) / (aw, aw, hd) in qkv's dtype.
    valid: the real (h, w) of a padded grid; rows outside ``[:h, :w]`` of
    the result are unspecified (see the module docstring).
    Returns (B, HP, WP, dim) in qkv's dtype. A CUDA grid runs the kernel; a
    CPU grid runs ``window_attention_reference``. ``window_attention.launches``
    counts the kernel's launches."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, num_heads, window, scale, rh, rw, valid)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {qkv.device}")
    if qkv.dim() != 4:
        raise ValueError(f"window_attention: expected (B, HP, WP, 3*dim), got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention: expected float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("window_attention: qkv must be contiguous and 16-byte aligned")
    b, hp, wp, _ = qkv.shape
    dim, hd, ah, aw, gh, gw = _geometry(qkv.shape, num_heads, window)
    valid = _valid_extent(qkv.shape, window, valid)
    if hd not in _HEAD_DIMS:
        raise ValueError(f"window_attention: head dim {hd} not in {_HEAD_DIMS}")
    if (rh is None) != (rw is None):
        raise ValueError("window_attention: pass both rel-pos tables or neither")
    if rh is not None:
        for name, t, a in (("rh", rh, ah), ("rw", rw, aw)):
            if t.shape != (a, a, hd) or t.dtype != qkv.dtype or t.device != qkv.device:
                raise ValueError(
                    f"window_attention: {name} must be ({a}, {a}, {hd}) {qkv.dtype} on"
                    f" {qkv.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
                )
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"window_attention: {name} must be contiguous and 16-byte aligned")
    if shared_memory_bytes(hd, ah, aw, rh is not None, qkv.dtype) > _SMEM_MAX:
        raise ValueError(f"window_attention: a {ah}x{aw} window does not fit shared memory")
    if ah * aw >= 2**21:
        raise ValueError("window_attention: a window holds 2**21 tokens or more")
    out = torch.empty((b, hp, wp, dim), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    launch(_kernel(), qkv, out, num_heads, window, scale, rh, rw, valid)
    window_attention.launches += 1
    return out


def launch(lib, qkv, out, num_heads, window, scale, rh=None, rw=None, valid=None) -> None:
    """One launch of ``lib``'s ``wsi_window_attention_rows`` (``bind``
    declared it) on inputs that ``window_attention`` has checked; with
    ``valid`` None, of ``wsi_window_attention`` (every row; every build has
    it). Counts nothing."""
    b, hp, wp, _ = qkv.shape
    dim, hd, ah, aw, gh, gw = _geometry(qkv.shape, num_heads, window)
    args = [
        qkv.data_ptr(), out.data_ptr(),
        rh.data_ptr() if rh is not None else None,
        rw.data_ptr() if rw is not None else None,
        int(qkv.dtype == torch.bfloat16), hd,
        b, hp, wp, dim, num_heads, ah, aw, gh, gw,
    ]
    # The stream of qkv's device, not of whichever device is current.
    tail = [_rounded_scale(scale, qkv.dtype), torch.cuda.current_stream(qkv.device).cuda_stream]
    with torch.cuda.device(qkv.device):
        if valid is None:
            err = lib.wsi_window_attention(*args, *tail)
        else:
            err = lib.wsi_window_attention_rows(*args, *valid, *tail)
    if err != 0:
        raise RuntimeError(
            f"window_attention launch failed: {lib.wsi_cuda_error_string(err).decode()}"
        )


window_attention.launches = 0
