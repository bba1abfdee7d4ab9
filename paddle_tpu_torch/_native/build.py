"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes``: no PyTorch headers are compiled, so a build takes seconds.
Libraries go into ``paddle_tpu_torch/_native/_build/`` under a name that
carries a digest of the source, the headers of ``csrc/`` and the flags, so
an edited source or header is rebuilt and an unchanged one is reused. Nothing is built at import: the first call
of a kernel's wrapper builds its library, and :func:`build` compiles several
sources at once, one ``nvcc`` process for each, all started together.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -I csrc: a copy of a source elsewhere (a planted fault, an A/B build)
# still finds the headers of csrc/ (fused_io.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
              str(CSRC))

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what ptxas said about each kernel (registers, shared memory, spills)
build_logs: Dict[str, str] = {}


def sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built "
            "from paddle_tpu_torch/csrc on first use")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):   # what the sources include
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet, in
    parallel. Raises with the compiler's output if any build fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")


class LaunchCounter:
    """Counts a kernel's launches: its wrapper calls :meth:`launched` where
    it launches the kernel and nowhere else, so a run can show that its
    main path went through the kernel. A CUDA graph launches the kernels
    its capture recorded without passing through the wrappers: its replays
    count them with :meth:`add`, by the amounts :func:`recorded_launches`
    took at capture.

    Safe from several threads (two engines' loop threads replay at once):
    both are one locked increment. While a capture records, every
    wrapper's launch goes to the recording, whichever thread makes it (the
    autograd engine runs a captured backward on threads of its own), and
    replays go on counting: the captures that may overlap other threads'
    work (the serving engines') hold a process-wide lock from their warm-up
    calls to the end of the capture, so no other wrapper launches then."""

    def __init__(self, name: str):
        self.name = name
        self._count = 0
        _counters.append(self)

    @property
    def count(self) -> int:
        """Launches made so far (a capture in progress adds none)."""
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        self.launched(value - self._count)

    def reset(self) -> None:
        with _count_lock:
            self._count = 0

    def launched(self, n: int = 1, cost: Optional[Callable] = None,
                 *args) -> None:
        """A wrapper launched its kernel (``n`` times): counted, or taken
        by the recording of a capture in progress. ``cost(*args)`` is the
        launch's ``(flops, bytes)`` (the cost function beside the wrapper):
        called only while the program cost registry counts an eager call
        (:data:`cost_hook` set), so a launch otherwise pays one None test."""
        hook = cost_hook
        if hook is not None and cost is not None:
            hook(self.name, n, cost, args)
        with _count_lock:
            if _recordings:
                rec = _recordings[-1]
                rec[self] = rec.get(self, 0) + n
            else:
                self._count += n

    def add(self, n: int) -> None:
        """Count ``n`` launches made by a replay of a captured graph."""
        with _count_lock:
            self._count += n


#: set by ``observability.cost`` while it counts one eager call of a
#: program: every wrapper launch hands it ``(counter name, launches, cost
#: function, its arguments)``, and the registry calls the cost function.
#: None otherwise (and always inside a graph capture: the registry counts
#: the warm-up call before it).
cost_hook: Optional[Callable[[str, int, Callable, tuple], None]] = None


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors (None skipped), each counted once as a whole:
    what a kernel moves reading each input and writing each output once."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def io_cost(*ts) -> Tuple[float, float]:
    """The cost function of a kernel that does no matrix products: no
    flops counted, and :func:`tensor_bytes` of the tensors it reads and
    writes (the elementwise, norm and row kernels K1-K8)."""
    return 0.0, float(tensor_bytes(*ts))


_counters: List[LaunchCounter] = []
_count_lock = threading.Lock()
# the dicts of the recorded_launches regions open in the process, innermost
# last
_recordings: List[Dict[LaunchCounter, int]] = []


@contextlib.contextmanager
def recorded_launches() -> Iterator[Dict[LaunchCounter, int]]:
    """Around a CUDA graph capture: yields a dict of the launches the
    wrappers made inside the region, by counter, which leave every count
    as it was, since a capture records the launches without making them.
    Replays of other graphs meanwhile are counted as usual."""
    recorded: Dict[LaunchCounter, int] = {}
    with _count_lock:
        _recordings.append(recorded)
    try:
        yield recorded
    finally:
        with _count_lock:
            _recordings.remove(recorded)
            for c in [c for c, n in recorded.items() if n == 0]:
                del recorded[c]
