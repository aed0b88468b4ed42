"""paffy_tpu's native C library, loaded for sure, for the port's tests.

paffy_tpu builds its library lazily from every process into one shared
temporary name and, when a build fails, sets a sticky flag and falls back
to its numpy code without a word (paffy_tpu/native/__init__.py:54-80).  Its
fallback and its native route disagree on some inputs (a raw ``chain``
cigar with a leading zero, ``invert``'s bounds messages, ``short.paf``,
``split_file`` of a short record, ``upconvert`` of a non-canonical cigar),
and the port follows the native route.  So a test that holds the port to
paffy_tpu runs paffy_tpu on its library: ``ref_lib`` takes a lock, retries
a failed load, and fails with the compiler's own error rather than let the
comparison run against the fallback.  ``paffy_tpu_lib`` is the module
fixture of every test file that reaches paffy_tpu's native code.
"""

import fcntl
import os
import subprocess
import tempfile
import time

import pytest

from paffy_tpu import native as ref_native

ATTEMPTS = 3
LOCK_PATH = os.path.join(tempfile.gettempdir(), "paffy_tpu_native.lock")


def _build_error() -> str:
    """The compiler's output for paffy_tpu's library, built apart."""
    with tempfile.TemporaryDirectory() as d:
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
               ref_native._SRC, "-o", os.path.join(d, "libpaffy_io.so")]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            return f"{' '.join(cmd)}: {e}"
        return f"{' '.join(cmd)}: exit code {p.returncode}\n{p.stderr}"


def ref_lib():
    """paffy_tpu's loaded library.  Under a lock file shared by every
    process of the run, up to ``ATTEMPTS`` loads, each after clearing
    paffy_tpu's sticky failure flag; fails the test if none loads."""
    errors = []
    with open(LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(ATTEMPTS):
            try:
                lib = ref_native.get_lib()
            except OSError as e:          # loaded a file another wrote
                errors.append(str(e))
                lib = None
            if lib is not None:
                return lib
            ref_native._failed = False
            time.sleep(attempt + 1)
    pytest.fail("paffy_tpu's native library does not load "
                f"({'; '.join(errors) or 'its build failed'}):\n"
                f"{_build_error()}", pytrace=False)


@pytest.fixture(scope="module", autouse=True)
def paffy_tpu_lib():
    return ref_lib()
