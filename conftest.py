"""Compile-cache isolation for the tests that launch multi-process servers.

``tests/test_bootstrap_twoprocess.py`` and ``tests/test_pd_multihost.py``
start groups of ``engine serve`` processes with one configuration
(qwen3-tiny, float32, tensor parallel 2).  The servers persist compiled
executables into the cache directory their environment names
(``FUSIONINFER_AOT_CACHE``, else ``/tmp/fusioninfer-xla-cache``), and a
two-process group that loads the executables the PD test's groups
persisted hangs in its first decode until the client times out (see the
reference caveats in ROADMAP.md).  Under ``pytest -n`` the two files run
at the same time on different workers, so the tp2 decode test passed or
failed on which file's servers compiled first, and any earlier run left
the shared directory warm for the next.  Each test of these two files
gets an empty cache directory of its own: its servers boot as on a fresh
machine, which is the case the tests describe.  Nothing else changes for
them or for any other test.
"""

import pytest

_MULTIPROCESS_SERVER_TESTS = ("test_bootstrap_twoprocess.py", "test_pd_multihost.py")


@pytest.fixture(autouse=True)
def _own_compile_cache(request, tmp_path_factory, monkeypatch):
    if request.path.name in _MULTIPROCESS_SERVER_TESTS:
        monkeypatch.setenv("FUSIONINFER_AOT_CACHE",
                           str(tmp_path_factory.mktemp("compile-cache")))
