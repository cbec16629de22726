"""The Mamba2 SSD chunk-scan kernel for Hopper: wrapper and launch count.

Counterpart of ``repro.kernels.ssd_scan``.  The kernel is CUDA C++ in
``csrc/ssd_scan.cu`` (the source notes which TPU kernel it replaces, its
bound and what the design does about it), built at first use by
:mod:`.build` and loaded with ``ctypes``.

It takes the reference's layout: ``x [B, L, H, P]``, ``dt [B, L, H]`` f32,
``A [H]`` f32, ``Bm``/``Cm [B, L, G, N]`` and an optional initial state
``[B, H, P, N]`` f32; x, B and C in float32 or bfloat16 (one dtype).  A
tensor on the CPU goes to the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises; a ``meta`` tensor (the dry run) gets outputs
of the right shapes, allocates the launch's scratch beside them (so an op
counter's peak of live bytes holds it) and launches nothing.  Every call reports its work to
an active op counter (:mod:`repro_torch.obs.cost`, :func:`scan_work`).  One
launch enqueues the source's three
kernels (chunk states and shared scores, state passing, chunk outputs); the
wrapper allocates their f32 scratch with ``torch.empty``: the chunk states
``[B, L / chunk, H, N, P]`` (134 MB at Mamba2-1.3B's 8 x 2,048 prefill), the
scores ``[B, L / chunk, G, chunk, chunk]`` and the cumsums ``[B, H, L]``.
The kernels have no backward: under autograd with an input that requires a
gradient the wrapper raises rather than return an output with no
``grad_fn``; ``models.mamba2.ssd_chunked`` is the differentiable entry
point.  ``LAUNCHES`` counts wrapper launches (one a call) only.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import cost
from . import ref
from .build import CudaLibrary, raise_on

HEAD_DIMS = (8, 16, 32, 64)       # P
STATE_DIMS = (16, 32, 64, 128)    # N
MAX_CHUNK = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"ssd_scan": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ptr] * 11 + [i32] * 8 + [ptr]
    lib.ssd_scan_launch.restype = i32


LIBRARY = CudaLibrary("ssd_scan.cu", _bind)


def reset_launch_counts() -> None:
    LAUNCHES["ssd_scan"] = 0


def scan_flops(B: int, L: int, H: int, P: int, N: int, Q: int, G: int) -> int:
    """The least work of the chunk scan: the ``C_i . B_j`` scores once per
    (b, group, chunk) for the ``Q (Q + 1) / 2`` pairs ``j <= i``; per (b,
    head, chunk) the intra term over the same pairs, the state read and the
    state update (``Q N P`` multiply-adds each)."""
    nc, pairs = L // Q, Q * (Q + 1) // 2
    return 2 * pairs * N * B * G * nc + (2 * pairs * P + 4 * Q * N * P) * B * H * nc


def scan_work(x, dt, A, Bm, chunk: int, initial_state) -> tuple[int, int]:
    """(flops, bytes) of one call: x, dt, A, B, C and the initial state read
    once; y and the f32 final state written once."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nbytes = (2 * x.numel() + 2 * Bm.numel()) * x.element_size() + 4 * (
        dt.numel() + A.numel() + B * H * P * N
        + (initial_state.numel() if initial_state is not None else 0))
    return scan_flops(B, L, H, P, N, chunk, G), nbytes


def _check(x, dt, A, Bm, Cm, chunk, initial_state) -> None:
    ins = (x, dt, A, Bm, Cm) + ((initial_state,) if initial_state is not None else ())
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        raise ValueError(f"ssd_scan: every input must lie on one CUDA device, got "
                         f"{[str(t.device) for t in ins]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError(
            "ssd_scan: the CUDA kernel has no backward; differentiate through "
            "models.mamba2.ssd_chunked, whose backward recomputes the plain scan")
    if x.dtype not in _DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: need x, Bm, Cm of one dtype, float32 or bfloat16, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    f32 = (dt, A) + ((initial_state,) if initial_state is not None else ())
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("ssd_scan: dt, A and the initial state must be float32")
    if x.ndim != 4 or Bm.ndim != 4:
        raise ValueError(f"ssd_scan: need x [B, L, H, P] and Bm, Cm [B, L, G, N], got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    want = {"dt": (dt, (B, L, H)), "A": (A, (H,)), "Bm": (Bm, (B, L, G, N)),
            "Cm": (Cm, (B, L, G, N))}
    if initial_state is not None:
        want["initial_state"] = (initial_state, (B, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, need {shape}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan: the group count G={G} must divide H={H}")
    if not 1 <= chunk <= MAX_CHUNK or L % chunk:
        raise ValueError(f"ssd_scan: the kernel takes a chunk in [1, {MAX_CHUNK}] that "
                         f"divides L, got chunk={chunk}, L={L}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: the kernel takes P in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got P={P}, N={N}")
    if B > 65535:
        raise ValueError(f"ssd_scan: B={B} exceeds the grid's limit of 65535")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_scan: every input must be contiguous")


def ssd_scan(
    x: torch.Tensor,   # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H] f32
    A: torch.Tensor,   # [H] f32
    Bm: torch.Tensor,  # [B, L, G, N]
    Cm: torch.Tensor,  # [B, L, G, N]
    chunk: int,
    initial_state: torch.Tensor | None = None,  # [B, H, P, N] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, L, H, P] in x's dtype, final state [B, H, P, N] f32)``."""
    with cost.kernel("ssd_scan", *scan_work(x, dt, A, Bm, chunk, initial_state)):
        if x.device.type == "cpu":
            return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, initial_state)
        if x.device.type == "meta":  # the launch's allocations, so a counter sees its peak
            y, fin, scratch = _buffers(x, Bm, chunk)
            del scratch
            return y, fin
        return _launch(x, dt, A, Bm, Cm, chunk, initial_state)


def _buffers(x, Bm, chunk: int):
    """``(y, final state, (chunk states, scores, cumsums))``: the outputs
    and the f32 scratch of one launch, on ``x``'s device."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    nc = L // chunk
    scratch = (torch.empty((B, nc, H, N, P), **f32), torch.empty((B, nc, G, chunk, chunk), **f32),
               torch.empty((B, H, L), **f32))
    return torch.empty_like(x), torch.empty((B, H, P, N), **f32), scratch


def _launch(x, dt, A, Bm, Cm, chunk: int, initial_state) -> tuple[torch.Tensor, torch.Tensor]:
    _check(x, dt, A, Bm, Cm, chunk, initial_state)
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    lib = LIBRARY.load()
    y, fin, (states, scores, acs) = _buffers(x, Bm, chunk)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(), y.data_ptr(),
        fin.data_ptr(), states.data_ptr(), scores.data_ptr(), acs.data_ptr(),
        _DTYPE_CODES[x.dtype], B, L, H, P, G, N, chunk, stream,
    )
    raise_on("ssd_scan", err)
    LAUNCHES["ssd_scan"] += 1
    return y, fin


__all__ = ["LIBRARY", "LAUNCHES", "HEAD_DIMS", "STATE_DIMS", "MAX_CHUNK",
           "reset_launch_counts", "scan_flops", "scan_work", "ssd_scan"]
