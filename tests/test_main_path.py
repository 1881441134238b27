"""The scan's main path (Scanner, .dcp I/O, the amino-Forward confirmer,
the kernel wrapper, the device mesh, chip_smoke.py) imports only JAX,
numpy, scipy and the standard library: the packages below may be missing
where the scan runs."""

import os
import subprocess
import sys

OPTIONAL = {"msgpack", "click", "pydantic", "requests", "rich", "torch",
            "triton"}
MAIN_PATH = ("deciphon_tpu.scan.pipeline", "deciphon_tpu.io.dcp",
             "deciphon_tpu.hmmer", "deciphon_tpu.ops.viterbi_cuda",
             "deciphon_tpu.parallel.multidevice", "chip_smoke")


def test_main_path_imports_no_optional_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MAIN_PATH)
            + "print(' '.join(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    loaded = set(r.stdout.split())
    assert "jax" in loaded and "deciphon_tpu" in loaded
    assert not loaded & OPTIONAL, sorted(loaded & OPTIONAL)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    the code sets no other."""
    import jax

    from deciphon_tpu.utils import jaxcache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_fixed_in_checkout(monkeypatch):
    """Without it, one fixed directory inside the checkout, git-ignored."""
    import jax

    from deciphon_tpu.utils import jaxcache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxcache.cache_dir() == os.path.join(root, "build", "jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert jaxcache.enable_compilation_cache() == jaxcache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == jaxcache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(root, ".gitignore")) as fp:
        assert "build/" in fp.read().split()
