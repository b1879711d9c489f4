"""Build and binding of the package's CUDA kernels.

Every `csrc/*.cu` is compiled (sm_90a) into one shared library with a plain
C interface under `_build/`, at first use: one nvcc per source, all started
together, then one link; a file lock makes processes that start together
build once. The file name carries a hash of all sources,
headers and flags, so an edit of any of them builds anew. Functions are
bound with ctypes; `launch` sets the argument types (pointers and the
stream as `c_void_p`, or ctypes would cut them to 32 bits).
`count_launch` keeps a wrapper's launch counter true under CUDA graphs: a
launch made while a graph is captured runs nothing and is recorded, and
`count_replay` adds the recorded launches at each replay. A counter is
named "module" (its `KERNEL_LAUNCHES`) or "module:NAME" (a module of
several kernels, or a count of work beside the launches), or is an object
whose `add(n)` counts (work that a host int cannot hold).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = [
    "build_library", "check_tensor", "check_warp_scene", "launch",
    "count", "count_launch", "take_recorded", "count_replay",
    "VOID_P", "INT64", "INT", "FLOAT",
]

VOID_P, INT64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
FLOAT = ctypes.c_float

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
_lock = threading.Lock()
_lib = None
_bound: dict[str, object] = {}
# Launches recorded by the CUDA graph under capture, by the counter that
# counts them ("module", "module:NAME" or an object with `add`).
_recorded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from source at first use"
        )
    return str(path)


def _run_together(cmds):
    """Start every command at once, wait for all; raise if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library under _build/ unless a
    build of the same sources, headers and flags is there; returns its path."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in sources + sorted(_CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = _BUILD_DIR / f"libdensepoints_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Processes that start together (the ranks of a job) build once: the
    # first holds the lock while it builds, the others wait and load. The
    # kernel releases a process's lock when the process ends, however it
    # ends, so no lock outlives its holder.
    with open(_BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as objdir:
            objects = [str(Path(objdir) / f"{src.stem}.o")
                       for src in sources]
            _run_together([[nvcc, *_NVCC_FLAGS, "-c", "-o", obj, str(src)]
                           for src, obj in zip(sources, objects)])
            _run_together([[nvcc, "-shared", "-o", str(tmp), *objects]])
        os.replace(tmp, out)
    return out


def _bind(name: str, argtypes):
    """The library's C function `name` (returns a CUDA error code), built
    and loaded at first use."""
    global _lib
    with _lock:
        if name not in _bound:
            if _lib is None:
                _lib = ctypes.CDLL(str(build_library()))
            fn = getattr(_lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _bound[name] = fn
        return _bound[name]


def check_tensor(name, t, device, dtype, shape):
    """Raise unless `t` is what a kernel takes: device, dtype, shape,
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# Mirrors of csrc/warp_ncc_common.cuh: patches (warps) of a block, entries
# of a tile, words of shared memory per entry, for the patch frame and for
# the row, and the static limit of a block's shared memory.
_WARP_NCC_WARPS = 4
_WARP_NCC_TILE = 32
_WARP_NCC_ENTRY_WORDS = 12
_WARP_NCC_FRAME_WORDS = 12
_WARP_NCC_ROW_WORDS = 12
_SMEM_LIMIT_BYTES = 48 * 1024


def _texels_per_lane(k):
    """`texels_per_lane`: texels a lane holds, 0 above 256 (strided)."""
    n = k * k
    return 1 if n <= 32 else 2 if n <= 64 else 4 if n <= 128 else (
        8 if n <= 256 else 0)


def check_warp_scene(images, cameras_K, position, normal, ref, k):
    """Raise `ValueError` unless the warp + NCC kernels take these shapes:
    a (V, H, W) stack with H, W >= 2 and H * W below 2^31 (offsets inside a
    view's page are 32-bit), `position`, `normal` (B, 3) and `ref` (B,) of
    one batch size, and a texture side `k` that fits a block's shared
    memory (k <= 51). The number of view entries per patch is not limited:
    a warp takes them a tile at a time. Shapes only: no tensor is read, so
    it runs before any launch and on any device."""
    if images.ndim != 3:
        raise ValueError(
            f"images has shape {tuple(images.shape)}, expected (V, H, W)"
        )
    V, H, W = images.shape
    if V < 1 or H < 2 or W < 2:
        raise ValueError(f"image stack {tuple(images.shape)} below 1 x 2 x 2")
    if H * W >= 2**31:
        raise ValueError(
            f"a view of {H} x {W} pixels: the kernel's offsets inside a view "
            "are 32-bit, H * W must stay below 2^31"
        )
    if tuple(cameras_K.shape) != (V, 3, 3):
        raise ValueError(
            f"K has shape {tuple(cameras_K.shape)}, expected {(V, 3, 3)}"
        )
    B = position.shape[0]
    for name, t, shape in (("position", position, (B, 3)),
                           ("normal", normal, (B, 3)), ("ref", ref, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {shape}: "
                "position, normal and ref are one batch"
            )
    # A tile's entries, the frame, the row and the anchor texture (32 T
    # texels, or k * k in the strided variant), rounded up to 16 bytes, for
    # each warp of a block.
    T = _texels_per_lane(k)
    words = (_WARP_NCC_ENTRY_WORDS * _WARP_NCC_TILE + _WARP_NCC_FRAME_WORDS
             + _WARP_NCC_ROW_WORDS + (32 * T if T else k * k))
    words = -(-words // 4) * 4
    if k < 1 or 4 * _WARP_NCC_WARPS * words > _SMEM_LIMIT_BYTES:
        raise ValueError(
            f"texture_size {k} outside the kernel's range: k >= 1 and, for "
            f"each of the {_WARP_NCC_WARPS} patches of a block, the "
            f"{_WARP_NCC_TILE} entries of a tile, the patch frame, the row "
            f"and the anchor texture within {_SMEM_LIMIT_BYTES} bytes of "
            "shared memory"
        )
    return V, H, W, B


def launch(name: str, argtypes, device, *args):
    """Call kernel launcher `name` on `device`'s current stream (appended as
    the last argument); raises if the launch is refused."""
    import torch

    fn = _bind(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def count(counter, n: int = 1):
    """Add `n` to `counter` ("module": its `KERNEL_LAUNCHES`;
    "module:NAME": its `NAME`; an object: its `add(n)`)."""
    import sys

    if not isinstance(counter, str):
        counter.add(n)
        return
    module, _, name = counter.partition(":")
    name = name or "KERNEL_LAUNCHES"
    setattr(sys.modules[module], name,
            getattr(sys.modules[module], name) + n)


def count_launch(counter, n: int = 1):
    """`count(counter, n)` for one launch on a CUDA stream, or, while the
    current stream captures a CUDA graph, record it for the graph's replays
    (a capture launches nothing)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        _recorded[counter] = _recorded.get(counter, 0) + n
    else:
        count(counter, n)


def take_recorded() -> dict:
    """The launches recorded since the last call, by counter; clears
    them."""
    out = dict(_recorded)
    _recorded.clear()
    return out


def count_replay(recorded: dict):
    """Count one replay of a graph that recorded `recorded`."""
    for counter, n in recorded.items():
        count(counter, n)
