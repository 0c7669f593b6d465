"""The reference's native libraries, whole on disk before a port test calls
them.

``linops_tpu/native/__init__.py`` builds each library with ``g++ … -o
<final path>`` whenever that path does not exist yet. Under pytest-xdist a
second worker can find the file half written, fail to load it, and mark the
library as tried: from then on that worker sees ``native_available()`` as
False, and a reference call that needs the library skips its native part
or raises. ``ensure_reference_native`` repairs that for the calling
process: under an ``fcntl`` lock on a file beside the libraries it builds
any library that is missing or does not load into a temporary name and
``os.replace``s it in (a reader sees the old file or the whole new one),
then clears the module's "tried" flags if this process already gave up and
loads both libraries again. The port's own loader builds the same way
(``linops_tpu_torch/native.py``).
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile

LOCK_NAME = "_native_build.lock"


def _loads(path: str) -> bool:
    if not os.path.exists(path):
        return False
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def _build_whole(src: str, so: str, stem: str) -> None:
    """``src`` built into a temporary file beside ``so``, then moved onto
    it in one step."""
    fd, tmp = tempfile.mkstemp(prefix=f"_{stem}.tmp.", suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread", src, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_reference_native(native=None) -> None:
    """Make ``native``'s (default: ``linops_tpu.native``) BSR packer and
    Clos router whole on disk and loaded in this process; assert that
    ``native_available()`` is True."""
    if native is None:
        import linops_tpu.native as native

    libs = ((native._SRC, "libbsrpack"), (native._CLOS_SRC, "libclosroute"))
    here = os.path.dirname(os.path.abspath(native._SRC))
    with open(os.path.join(here, LOCK_NAME), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for src, stem in libs:
                so = native._so_path(src, stem)
                if not _loads(so):
                    _build_whole(src, so, stem)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with native._lock:  # this process gave up on a half-written file: try again
        if native._tried and native._lib is None:
            native._tried = False
        if native._clos_tried and native._clos_lib is None:
            native._clos_tried = False
    assert native.native_available(), "the reference's BSR packer does not load"
    assert native._load_clos() is not None, "the reference's Clos router does not load"
