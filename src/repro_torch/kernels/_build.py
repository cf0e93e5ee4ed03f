"""Build, load and launch the port's CUDA kernels.

At first use, one ``nvcc`` per ``csrc/*.cu``, all started together,
compiles the sources for ``sm_90a``, and one more links them into one
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers are compiled, so the build takes seconds: as long as
the slowest source). The library lands in ``src/repro_torch/_build/`` (gitignored),
named by a hash of the sources, the headers beside them (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds and
an unchanged one is reused within a checkout.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``;
:func:`launch` raises on a non-zero code and counts the launch in
:data:`launches` — the counters a run reads to show that its main path went
through the kernels.

:func:`booking` is where a wrapper books its kernel's work with an op
counter (``launch/op_analysis.py``, which registers itself here: this
layer imports nothing above it). With no counter open in the process it
costs one integer test: the work is not computed and :func:`launch` checks
nothing.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, ContextManager, Dict, Optional, Tuple

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the link step's libraries: flash_attention.cu finds the driver's tensor-map
# encoder with dlopen / dlsym
LINK_LIBS = ("-ldl",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p, sizes and flags as int64, f32 scalars as c_float)
SIGNATURES = {
    # codes, scale, zero, idx, out, m, rowlen, vec, stream
    "gather_dequant_rows_q8": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # e, v, out, B, F, K, bf16, stream
    "ffm_interaction_matrix": (_P, _P, _P, _I, _I, _I, _I, _P),
    # ectx, vctx, ecx, ecc, vcand, xc, aa, strides[11], R, N, Fc, Fcand, K,
    # vec8, stream
    "ffm_candidate_matrices": (_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P),
    # as above with scale, zero after vcand
    "ffm_candidate_matrices_q8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P),
    # ectx, vctx, depth, base, qcx, qcc, scale, zero, vcand, logits,
    # ctx_dots, strides[11], R, N, Fc, Fcand, K, vec8, stream
    "ffm_fused_logits_q8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P),
    # as above with ecx, ecc and without scale, zero
    "ffm_fused_logits_rows": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _P),
    # w, partials, ticket, out, n, vec, stream
    "minmax": (_P, _P, _P, _P, _I, _I, _P),
    # w, q, w_min, bucket, n, vec, stream
    "quantize_codes": (_P, _P, _F, _F, _I, _I, _P),
    # q, w, w_min, bucket, n, vec, stream
    "dequantize_codes": (_P, _P, _F, _F, _I, _I, _P),
    # x, g, out, B, I, J, stream
    "sparse_weight_grad": (_P, _P, _P, _I, _I, _I, _P),
    # q, k, v, out, lse (or null), B, Sq, Sk, H, Kv, D, Dv, causal, window,
    # bf16, scale, stream
    "flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _F, _P),
    # K13: q, k, v, o, lse, dout, dq, delta, then as above from B
    "flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # K12: q, k, v, dout, lse, delta, dk, dv, then as above from B
    "flash_attention_bwd_dkdv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _P),
}

# launches per kernel since the last reset (plain integers; set them to 0 to
# reset). Only a launch of the CUDA kernel counts, never the plain version.
launches: Dict[str, int] = dict.fromkeys(SIGNATURES, 0)
# a count's read-modify-write is not atomic across threads (Hogwild's
# workers, the update pipe's thread and the scorers launch concurrently)
_count_lock = threading.Lock()

# op counters open in the process, and the two hooks the counter registers
# (``launch/op_analysis.py``): ``_book(name, flops, nbytes)``, a context
# booking one call with the counters active on this thread, and
# ``_check_launch(name)``, raising on a launch outside a booking
_open_counters = 0
_book: Optional[Callable[[str, int, int], ContextManager]] = None
_check_launch: Optional[Callable[[str], None]] = None
_NO_BOOKING = contextlib.nullcontext()


def register_counter(book, check_launch) -> None:
    """Install the op counter's hooks (see :func:`booking`)."""
    global _book, _check_launch
    _book, _check_launch = book, check_launch


def counter_opened(delta: int) -> None:
    """An op counter was entered (+1) or left (-1)."""
    global _open_counters
    with _count_lock:
        _open_counters += delta


def booking(name: str, work: Callable[[], Tuple[int, int]]
            ) -> ContextManager:
    """A context that books one call of kernel ``name`` with every op
    counter active on this thread: ``work()`` gives its (operations,
    bytes), and is called only while a counter is open; the ops dispatched
    in the body are not counted. With no counter open, nothing."""
    if not _open_counters:
        return _NO_BOOKING
    return _book(name, *work())


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when a built library was reused
    log: str              # nvcc / ptxas output of the build


_lock = threading.Lock()
_library: Optional[Library] = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _compile() -> Library:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_LIBS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):  # headers too
        h.update(src.name.encode() + src.read_bytes())
    so = BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        nvcc = nvcc_path()
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        t0 = time.perf_counter()
        objs = [so.with_name(f"{so.stem}.{os.getpid()}.{src.stem}.o")
                for src in sources]
        procs = []
        try:
            for src, obj in zip(sources, objs):
                procs.append(subprocess.Popen(
                    [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs = [proc.communicate(timeout=600)[0] for proc in procs]
            failed = [f"{src.name} ({proc.returncode}):\n{out}"
                      for src, proc, out in zip(sources, procs, logs)
                      if proc.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs),
                 *LINK_LIBS], capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for obj in objs:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log_path.write_text("".join(logs) + proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return Library(lib, so, seconds, log)


def load() -> Library:
    """The built kernel library (compiled on first call in the process)."""
    global _library
    with _lock:
        if _library is None:
            _library = _compile()
        return _library


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on PyTorch's current stream (appended as
    the last argument); raise on a CUDA error, else count the launch. Under
    an open op counter the call must be booked (:func:`booking`)."""
    if _open_counters:
        _check_launch(name)
    lib = load().lib
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    count_launch(name)


def count_launch(name: str) -> None:
    """Add one to ``launches[name]``, safely from any thread."""
    with _count_lock:
        launches[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: Optional[tuple] = None, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` (and ``shape`` and
    contiguity when asked) — what every kernel wrapper checks."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
