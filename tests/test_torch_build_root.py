"""Where the port builds its kernels and native tables
(``libiqo_tpu_torch/utils/build_root.py``): a writable source checkout
builds into its own ``build/``; an installed package, or a checkout that
cannot be written, builds under ``$LIBIQO_TPU_CACHE`` or the temporary
directory and never into the install.  Stand-in package directories, no
compiler run.
"""

from __future__ import annotations

import os
import stat
import tempfile
from pathlib import Path

import pytest

from libiqo_tpu_torch.coeffs import native
from libiqo_tpu_torch.ops import _build
from libiqo_tpu_torch.utils import build_root as br

ROOT = Path(__file__).resolve().parent.parent


def _package(root: Path, checkout: bool) -> Path:
    pkg = root / "libiqo_tpu_torch"
    pkg.mkdir(parents=True)
    if checkout:
        (root / "pyproject.toml").write_text("[project]\nname = 'stand-in'\n")
    return pkg


def test_this_checkout_builds_beside_the_package():
    assert br.build_root(ROOT / "libiqo_tpu_torch") == ROOT / "build" / "libiqo_tpu_torch"
    assert _build.build_dir().parent == ROOT / "build" / "libiqo_tpu_torch"
    assert native._build_dir().parent == ROOT / "build" / "libiqo_tpu_torch"


@pytest.mark.parametrize("cache", [None, "env"])
def test_a_read_only_install_builds_in_the_cache(tmp_path, monkeypatch, cache):
    """A package in a read-only ``site-packages`` (no ``pyproject.toml``
    beside it): the kernels, the probes and the native tables all build
    under ``$LIBIQO_TPU_CACHE``, else the temporary directory."""
    site = tmp_path / "site-packages"
    pkg = _package(site, checkout=False)
    site.chmod(stat.S_IRUSR | stat.S_IXUSR)
    try:
        if cache is None:
            monkeypatch.delenv("LIBIQO_TPU_CACHE", raising=False)
            want = Path(tempfile.gettempdir()) / "libiqo_tpu_cache" / "libiqo_tpu_torch"
        else:
            monkeypatch.setenv("LIBIQO_TPU_CACHE", str(tmp_path / "cache"))
            want = tmp_path / "cache" / "libiqo_tpu_torch"
        monkeypatch.setattr(_build, "_PKG", pkg)
        monkeypatch.setattr(native, "_PKG", pkg)
        for d in (_build.build_dir(), _build.exp_build_dir(), native._build_dir()):
            assert d.parent == want
            assert site not in d.parents
    finally:
        site.chmod(stat.S_IRWXU)


def test_a_checkout_that_cannot_be_written_builds_in_the_cache(tmp_path, monkeypatch):
    """A checkout whose directory the process may not write (read-only to
    it; the check asks ``os.access``, which a superuser always passes, so
    the test answers for it) builds in the cache too."""
    pkg = _package(tmp_path / "repo", checkout=True)
    monkeypatch.setenv("LIBIQO_TPU_CACHE", str(tmp_path / "cache"))
    assert br.build_root(pkg) == tmp_path / "repo" / "build" / "libiqo_tpu_torch"
    monkeypatch.setattr(br, "_writable", lambda p: not os.path.samefile(p, tmp_path / "repo"))
    assert br.build_root(pkg) == tmp_path / "cache" / "libiqo_tpu_torch"
    (tmp_path / "repo" / "build").mkdir()
    assert br.build_root(pkg) == tmp_path / "repo" / "build" / "libiqo_tpu_torch"
