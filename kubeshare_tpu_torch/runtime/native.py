"""Build the node side's native pieces at first use.

- ``build_binary(name)``: ``tpu-pmgr`` or ``libtpuhook.so`` of the
  native isolation runtime, brought up to date with ``make -C
  runtime_native build/<name>`` (g++ only; a no-op when the output is
  newer than its sources), so an output older than its sources is
  rebuilt, not run. Without ``make`` an existing output is used as it
  is. Concurrent callers (several test processes, a launcher and a
  bench) take a file lock around the build, so none runs a half-written
  binary. ``tpu-schd`` is the port's own (``build_schd``).
- ``build_schd()``: the port's token arbiter, ``csrc/tpu_schd.cc`` over
  ``csrc/arbiter.h`` (``runtime_native``'s daemon and policy, whose
  grant also reports how long the ACQ waited and how much of that the
  pod was past its limit), with ``runtime_native/proto.h``'s protocol;
  built with g++ beside the port's kernels in ``build/torch_kernels/``,
  named by a hash of its sources and flags.
- ``build_interposer(check_cuda_h=False)``: the CUDA driver-API
  interposer, ``csrc/cuda_interposer.cc`` (with its hand-declared driver
  types, ``csrc/cuda_decls.h``), built with g++ (it has no
  device code and links no ``libcuda``) beside the port's kernels in
  ``build/torch_kernels/``, named by a hash of its source and flags as
  ``ops/_build.py`` names a kernel library (source, header and flags).
  ``check_cuda_h`` builds it
  once more against the real ``<cuda.h>`` (``-DKUBESHARE_CHECK_CUDA_H``),
  whose ``static_assert``s fail the build on a prototype that disagrees
  with the driver's; it needs the CUDA toolkit's headers.
- ``install_interposer(dest)``: that build, written atomically (a
  temporary file, then a rename) to ``dest/libcuda_interposer.so``, the
  name the admission webhook preloads from the node's library directory
  (``cluster/webhook.py``) and ``runtime/interposer.py::find_interposer``
  looks for. ``python -m kubeshare_tpu_torch.runtime.native --install
  DIR`` runs it: the node daemon's install step, as the reference's
  initContainer copies its PJRT shim there.

Nothing is built at import time.
"""

from __future__ import annotations

import argparse
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

from ..constants import INTERPOSER_LIBRARY
from ..ops._build import BUILD_DIR

REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO / "runtime_native"
NATIVE_BUILD = NATIVE_DIR / "build"
_CSRC = Path(__file__).resolve().parent / "csrc"
GXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread",
             "-shared")
SCHD_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-pthread",
              "-I" + str(NATIVE_DIR))
SCHD_SOURCES = (_CSRC / "tpu_schd.cc", _CSRC / "arbiter.h",
                NATIVE_DIR / "proto.h")
# where the CUDA toolkit's headers are looked for by check_cuda_h
CUDA_INCLUDE = ("/usr/local/cuda/include",)


def build_binary(name: str) -> str:
    """The path of ``runtime_native/build/<name>``, made up to date
    first (``tpu-schd``: ``build_schd``'s); raises if the build fails,
    or if there is no ``make`` and no output."""
    if name == "tpu-schd":
        return str(build_schd())
    path = NATIVE_BUILD / name
    if shutil.which("make") is None:
        if path.exists():
            return str(path)
        raise RuntimeError(f"{path} is not built and make is not found")
    NATIVE_BUILD.mkdir(parents=True, exist_ok=True)
    with open(NATIVE_BUILD / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        out = subprocess.run(["make", "-C", str(NATIVE_DIR), f"build/{name}"],
                             capture_output=True, text=True)
        if out.returncode != 0 or not path.exists():
            raise RuntimeError(
                f"building {path} failed ({out.returncode}):\n"
                f"{out.stdout}{out.stderr}")
    return str(path)


def _hashed(stem: str, sources: Sequence[Path], flags: Sequence[str]
            ) -> Path:
    """``build/torch_kernels/<stem>-<hash of sources and flags>``."""
    digest = hashlib.sha256()
    for source in sources:
        digest.update(source.read_bytes())
    digest.update(" ".join(flags).encode())
    name, dot, suffix = stem.partition(".")
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}{dot}{suffix}"


def _gxx(out: Path, flags: Sequence[str], source: Path,
         libs: Sequence[str], what: str) -> Path:
    """Compile ``source`` to ``out`` with g++ unless ``out`` is there;
    written through a temporary file and a rename, so a concurrent
    build sees all of it or none."""
    if out.exists():
        return out
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: it builds {what}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *flags, "-o", str(tmp), str(source), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {what} ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_schd() -> Path:
    """Compile the port's ``tpu-schd`` with g++ unless it is already
    built; returns its path."""
    return _gxx(_hashed("tpu-schd", SCHD_SOURCES, SCHD_FLAGS), SCHD_FLAGS,
                _CSRC / "tpu_schd.cc", (), "tpu-schd")


def _cuda_include() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "include"))
    candidates.extend(CUDA_INCLUDE)
    for directory in candidates:
        if os.path.isfile(os.path.join(directory, "cuda.h")):
            return directory
    raise RuntimeError(f"cuda.h not found in {candidates}")


def interposer_flags(check_cuda_h: bool = False) -> tuple:
    flags = GXX_FLAGS
    if check_cuda_h:
        flags += ("-DKUBESHARE_CHECK_CUDA_H", "-I" + _cuda_include())
    return flags


def interposer_path(check_cuda_h: bool = False) -> Path:
    """Where the interposer built with these flags lies."""
    tag = "-check" if check_cuda_h else ""
    return _hashed(f"libcuda_interposer{tag}.so",
                   (_CSRC / "cuda_interposer.cc", _CSRC / "cuda_decls.h"),
                   interposer_flags(check_cuda_h))


def build_interposer(check_cuda_h: bool = False) -> Path:
    """Compile ``csrc/cuda_interposer.cc`` with g++ unless its library is
    already built; returns the library's path."""
    return _gxx(interposer_path(check_cuda_h), interposer_flags(check_cuda_h),
                _CSRC / "cuda_interposer.cc", ("-ldl",), "the CUDA interposer")


def install_interposer(dest) -> Path:
    """Build the interposer (``build_interposer``) and write it to
    ``dest/libcuda_interposer.so`` through a temporary file in ``dest``
    and a rename, so a pod that starts meanwhile preloads the old
    library or the new one, never half of one. Returns the path."""
    built = build_interposer()
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    out = dest / INTERPOSER_LIBRARY
    tmp = dest / f".{INTERPOSER_LIBRARY}.{os.getpid()}.tmp"
    try:
        shutil.copyfile(built, tmp)
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubeshare_tpu_torch.runtime.native",
        description="Build the CUDA interposer and install it into a "
                    "library directory.")
    parser.add_argument("--install", metavar="DIR", required=True,
                        help="the node's library directory, e.g. "
                             "/kubeshare/library")
    args = parser.parse_args(argv)
    print(install_interposer(args.install), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
