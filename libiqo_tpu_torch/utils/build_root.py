"""Where the port writes what it builds at run time: the CUDA kernels'
libraries (``ops/_build.py``) and the native coefficient tables
(``coeffs/native.py``).

A writable source checkout (``pyproject.toml`` beside the package) builds
into ``build/libiqo_tpu_torch/`` beside the package, a directory that
``.gitignore`` lists.  An installed package (in ``site-packages``, with no
``pyproject.toml`` beside it) or a read-only checkout builds under
``$LIBIQO_TPU_CACHE`` or, without it, the temporary directory, as the JAX
package's native tables do, so that it never writes into the install.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

__all__ = ["build_root"]


def _writable(path: Path) -> bool:
    return os.access(path, os.W_OK)


def build_root(pkg: Path) -> Path:
    """The directory that holds the builds of the package at ``pkg``."""
    checkout = pkg.parent
    if (checkout / "pyproject.toml").is_file():
        build = checkout / "build"
        if _writable(build if build.exists() else checkout):
            return build / "libiqo_tpu_torch"
    cache = os.environ.get("LIBIQO_TPU_CACHE") or str(Path(tempfile.gettempdir()) /
                                                      "libiqo_tpu_cache")
    return Path(cache) / "libiqo_tpu_torch"
