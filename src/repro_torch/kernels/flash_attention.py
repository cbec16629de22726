"""The flash-attention forward kernel for Hopper: wrapper and launch count.

Counterpart of ``repro.kernels.flash_attention``.  The kernel is CUDA C++ in
``csrc/flash_attention.cu`` (the source notes which TPU kernel it replaces,
its bound and what the design does about it), built at first use by
:mod:`.build` and loaded with ``ctypes``.

It takes the kernel layout, ``q [B, H, Sq, D]`` and ``k``/``v [B, KH, Sk,
D]``, in float32 (the tensor cores in 3xTF32, at f32 accuracy) or bfloat16
(the tensor cores, ``mma.sync``), at every length (``Sk >= 1``; the kernel
masks its last, partial q and key tiles) and every head dim ``0 < D <=
256``: a ``D`` outside ``HEAD_DIMS`` is zero-padded to the next one, the
kernel scales by ``1 / sqrt(D)`` of the unpadded ``D``, and the output is
sliced back.  A tensor on the CPU goes to the plain version in :mod:`.ref`;
a CUDA tensor launches the kernel or raises; a ``meta`` tensor (the dry run)
gets an output of the right shape and launches nothing.  Every call reports
its work to an active op counter (:mod:`repro_torch.obs.cost`,
:func:`attention_work`).  ``LAUNCHES`` counts kernel
launches only: ``"flash_attention"`` every launch,
``"flash_attention[noncausal]"`` those of them without the causal mask and
``"flash_attention[ragged]"`` those with a partial tile (a length not a
multiple of 64) or a padded head dim.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..obs import cost
from . import ref
from .build import CudaLibrary, raise_on

HEAD_DIMS = (32, 64, 128, 256)  # the kernel's; other D up to 256 are padded to these
BLOCK_Q = BLOCK_K = 64  # tile rows; a length that is not a multiple is masked
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention": 0, "flash_attention[noncausal]": 0,
            "flash_attention[ragged]": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr,
    ]
    lib.flash_attention_launch.restype = i32


LIBRARY = CudaLibrary("flash_attention.cu", _bind)


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def kernel_head_dim(D: int) -> int:
    """The kernel's head dim that a ``D`` in (0, 256] is zero-padded to."""
    return next(d for d in HEAD_DIMS if d >= D)


def attention_flops(B: int, H: int, Sq: int, Sk: int, D: int, causal: bool) -> int:
    """``4 * B * H * D`` (two products of ``D`` multiply-adds) for every
    (query, key) pair the kernel computes; causal from the top-left corner,
    where query ``i`` sees ``min(i + 1, Sk)`` keys."""
    if not causal:
        pairs = Sq * Sk
    elif Sq <= Sk:
        pairs = Sq * (Sq + 1) // 2
    else:
        pairs = Sk * (Sk + 1) // 2 + (Sq - Sk) * Sk
    return 4 * B * H * D * pairs


def attention_work(q: torch.Tensor, k: torch.Tensor, causal: bool) -> tuple[int, int]:
    """(flops, bytes) of one call at the call's own ``D`` (a padded head
    dim's zero columns are not the function's work): q, k and v read once,
    the output written once."""
    B, H, Sq, D = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return attention_flops(B, H, Sq, k.shape[2], D, causal), nbytes


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v must lie on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: need float32 or bfloat16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: need q [B, H, Sq, D] and k, v [B, KH, Sk, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (B, D) or KH == 0 or H % KH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         f"(batch, head dim, or H not a multiple of KH)")
    if not 0 < D <= HEAD_DIMS[-1] or Sk == 0:
        raise ValueError(f"flash_attention: the kernel takes 0 < D <= {HEAD_DIMS[-1]} and at "
                         f"least one key, got D={D}, Sq={Sq}, Sk={Sk}")
    if max(B, H) > 65535:
        raise ValueError(f"flash_attention: B={B}, H={H} exceed the grid's limit of 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, KH, Sk, D]
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention forward ``[B, H, Sq, D]`` in q's dtype; ``scale`` defaults
    to ``1 / sqrt(D)`` and the causal mask runs from the top-left corner."""
    with cost.kernel("flash_attention", *attention_work(q, k, causal)):
        if q.device.type == "cpu":
            return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
        if q.device.type == "meta":
            return torch.empty_like(q)
        return _launch(q, k, v, causal, scale)


def _launch(q, k, v, causal: bool, scale: float | None) -> torch.Tensor:
    _check(q, k, v)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    Dk = kernel_head_dim(D)
    if Dk != D:  # zero columns add nothing to q . k, and give zero output columns
        q, k, v = (torch.nn.functional.pad(x, (0, Dk - D)) for x in (q, k, v))
    lib = LIBRARY.load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
        B, H, KH, Sq, Sk, Dk, scale, int(causal), stream,
    )
    raise_on("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    if not causal:
        LAUNCHES["flash_attention[noncausal]"] += 1
    if Dk != D or Sq % BLOCK_Q or Sk % BLOCK_K:
        LAUNCHES["flash_attention[ragged]"] += 1
    return out[..., :D].contiguous() if Dk != D else out


__all__ = ["LIBRARY", "LAUNCHES", "HEAD_DIMS", "BLOCK_Q", "BLOCK_K", "reset_launch_counts",
           "kernel_head_dim", "attention_flops", "attention_work", "flash_attention"]
