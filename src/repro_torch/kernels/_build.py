"""Build and bind the port's CUDA kernels.

The sources under `csrc/` compile, at first use, into one shared library
with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -lineinfo \
         -shared -Xcompiler -fPIC

(`-lineinfo` keeps each instruction's source line, so that a fault or a
sanitizer report names the `.cu` line; it does not change the code.)

Each `.cu` compiles to an object in its own `nvcc` process, all started
together, and one more `nvcc` links them. No PyTorch header is included, so
a build takes seconds. The library lands in `build/<hash>/` beside this
module (a directory `.gitignore` lists); the hash covers every source and
the flags, so an edited source rebuilds and an unchanged one loads the
library already built.

Every C entry point takes tensor pointers and the stream as `c_void_p`,
ints as `c_int`, and returns `cudaGetLastError()`; `check` raises on a
non-zero code. Nothing here falls back: no compiler or no card raises.

Two hooks serve `kernels/sanitize.py`, and change nothing unless it sets
them: `use_checked_build()` loads a second library, compiled with
`-DREPRO_SANITIZE` (barrier checks and jitter, csrc/common.cuh), and the
wrappers allocate every output and scratch buffer through `empty`, which
calls `allocator` where one is set.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-lineinfo", "-Xcompiler",
                     "-fPIC"]
# the checked build's extra flag (barrier checks, jitter; csrc/common.cuh)
CHECKED_FLAGS = ["-DREPRO_SANITIZE"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_functions: Dict[str, object] = {}
_checked = False  # load the checked build (use_checked_build)
build_log: str = ""  # compiler output of the last build in this process
builds: int = 0      # libraries compiled in this process


def nvcc() -> str:
    """Path of `nvcc`: on PATH, else under $CUDA_HOME, else the toolkit's
    conventional install directory."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def flags(checked: bool = False) -> List[str]:
    return NVCC_FLAGS + (CHECKED_FLAGS if checked else [])


def source_hash(checked: bool = False) -> str:
    h = hashlib.sha256(" ".join(flags(checked)).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: Sequence[Sequence[str]]) -> str:
    """Run the commands in parallel; raise with their output if one fails."""
    procs = [subprocess.Popen(list(c), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, out)
              for c, p, out in zip(cmds, procs, outs) if p.returncode]
    if failed:
        msg = "\n".join(f"$ {' '.join(c)}\n(exit {rc})\n{out}"
                        for c, rc, out in failed)
        raise RuntimeError(f"building the CUDA kernels failed:\n{msg}")
    return "".join(outs)


def build(ptxas_info: bool = False, checked: bool = False) -> Path:
    """Compile the library unless this source hash is built already; return
    its path. `ptxas_info` adds `-Xptxas -v` (registers, shared memory and
    spills per kernel, kept in `build_log`) and always rebuilds; `checked`
    builds the checked library (`use_checked_build`)."""
    global build_log, builds
    out_dir = BUILD_DIR / source_hash(checked)
    lib = out_dir / LIB_NAME
    if lib.exists() and not ptxas_info:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        extra = ["-Xptxas", "-v"] if ptxas_info else []
        tool = nvcc()
        objs = [tmp / (src.stem + ".o") for src in sources()]
        log = _run([[tool, *flags(checked), *extra, "-I", str(CSRC), "-c",
                     str(src), "-o", str(obj)]
                    for src, obj in zip(sources(), objs)])
        log += _run([[tool, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
                      *map(str, objs)]])
        os.replace(tmp / LIB_NAME, lib)  # atomic: readers see a whole file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_log = log
    builds += 1
    return lib


def function(name: str, argtypes: Sequence) -> object:
    """The C entry point `name` of the built library, with its argtypes set
    and an int return (a cudaError_t). Builds and loads on first use."""
    global _lib
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            if _lib is None:
                _lib = ctypes.CDLL(str(build(checked=_checked)))
            fn = getattr(_lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[name] = fn
    return fn


def check(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{kernel}: CUDA kernel launch failed with "
                           f"cudaError {err}")


def use_checked_build() -> None:
    """Load the checked library (`-DREPRO_SANITIZE`) in place of the
    release one for the rest of the process. Call it before the first
    kernel launch."""
    global _checked
    with _lock:
        if _lib is not None and not _checked:
            raise RuntimeError("the release kernel library is loaded "
                               "already: choose the checked build first")
        _checked = True


# kernels/sanitize.py's allocator for outputs and scratch (`empty`); None
# keeps torch.empty
allocator: Optional[Callable[..., torch.Tensor]] = None


def empty(shape, dtype, device, label: str = "") -> torch.Tensor:
    """`torch.empty` for a kernel's output or scratch buffer, or
    `allocator`'s buffer where kernels/sanitize.py has set one (`label`
    names the buffer in its reports)."""
    if allocator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return allocator(shape, dtype, device, label)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous and 16-byte aligned, as kernels that copy with
    16-byte `cp.async` need (a view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def operand(t: torch.Tensor) -> torch.Tensor:
    """`t` as float32, contiguous and 16-byte aligned."""
    return aligned(t.float())


def knob_operand(value, n_lanes: int, device) -> torch.Tensor:
    """A quality knob (a number, a 0-d or an (L,) tensor) as the (L,)
    float32 device tensor a kernel reads it from: a tensor on `device`
    passes through as a view, so the knob is launch data and never a
    compile-time or host-side constant (lint rule A001)."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=device).reshape(max(n_lanes, 1)
                                                  ).contiguous()


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class Counter:
    """Launch count of one kernel wrapper, plus a device-side tally the
    kernel adds to (the tiles or blocks it actually computed or visited).

    `launches` is a plain int the wrapper bumps where it launches;
    `lane_calls` counts those launches that ran a lane stack (one call for
    L knobs). The tally is read only on request (`work()`), which
    synchronizes."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.lane_calls = 0
        self._work: Dict[torch.device, torch.Tensor] = {}

    def work_buffer(self, device: torch.device) -> torch.Tensor:
        buf = self._work.get(device)
        if buf is None:
            buf = torch.zeros((1,), dtype=torch.int64, device=device)
            self._work[device] = buf
        return buf

    def work(self) -> int:
        return sum(int(b.item()) for b in self._work.values())

    def launched(self, lanes: int) -> None:
        """Count one launch (of a lane stack when `lanes` > 0)."""
        self.launches += 1
        self.lane_calls += lanes > 0

    def reset(self) -> None:
        self.launches = 0
        self.lane_calls = 0
        for b in self._work.values():
            b.zero_()
