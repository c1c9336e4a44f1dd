"""Platform plumbing: the compile-cache rule, the kernel's interpret-mode
choice, the precision mapping, graph-build option validation, and loading
snapshots saved with options that no longer exist."""
import json

import jax
import numpy as np
import pytest

from zvdb_tpu.utils import cache


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory, and none set in code."""
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "elsewhere"))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert cache.setup_compile_cache() == str(tmp_path / "elsewhere")
    assert "jax_compilation_cache_dir" not in [k for k, _ in calls]


def test_compile_cache_fixed_in_repo_path(monkeypatch):
    """Unset: one fixed directory inside the checkout, the same every call
    (nothing derived from time, pid or a temp name)."""
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    d = cache.setup_compile_cache()
    repo = __file__.rsplit("/tests/", 1)[0]
    assert d == f"{repo}/.cache/jax" == cache.cache_dir()
    assert ("jax_compilation_cache_dir", d) in calls


@pytest.mark.parametrize("backend,expect", [
    ("cpu", True), ("gpu", False), ("rocm", NotImplementedError)])
def test_kernel_interpret_mode_by_backend(monkeypatch, backend, expect):
    """The Pallas kernels run interpreted only on the CPU (the test
    platform), compiled on the GPU; any other backend has no path."""
    from zvdb_tpu.ops import flat_scan

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is NotImplementedError:
        with pytest.raises(NotImplementedError):
            flat_scan.interpret_mode()
    else:
        assert flat_scan.interpret_mode() is expect


def test_precision_names_map_in_one_place():
    from zvdb_tpu.ops import distance as D

    assert D.matmul_precision("highest") == jax.lax.Precision.HIGHEST
    assert D.matmul_precision("float32") == jax.lax.Precision.HIGHEST
    # "high" is full f32: TF32 made results depend on the batch shape
    assert D.matmul_precision("high") == jax.lax.Precision.HIGHEST
    assert D.matmul_precision("default") == jax.lax.Precision.DEFAULT
    with D.precision_context("default"):
        assert jax.config.jax_default_matmul_precision is None
    with D.precision_context("high"):
        assert jax.config.jax_default_matmul_precision == "highest"


@pytest.mark.parametrize("make", ["hnsw", "cagra", "builder"])
def test_block_topk_validated(make):
    """block_topk accepts exactly the selections that exist."""
    from zvdb_tpu import CagraConfig, HNSWConfig
    from zvdb_tpu.index.knn_graph import build_knn_graph

    with pytest.raises(ValueError, match="block_topk"):
        if make == "hnsw":
            HNSWConfig(dim=8, block_topk="pallas")
        elif make == "cagra":
            CagraConfig(dim=8, block_topk="pallas")
        else:
            build_knn_graph(np.zeros((64, 8), np.float32), 4,
                            jax.random.PRNGKey(0), block_topk="pallas")


def test_graph_build_binfold_block_topk(rng):
    """block_topk='binfold' builds a graph of the same quality class."""
    from zvdb_tpu import CagraConfig, CagraIndex

    nc, n, d = 40, 5000, 16
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    x = (centers[rng.integers(0, nc, n)]
         + 0.12 * rng.standard_normal((n, d))).astype(np.float32)
    idx = CagraIndex(CagraConfig(dim=d, degree=16, block_topk="binfold"))
    idx.build(x)
    ids = np.asarray(idx.search(x[:512], 1, ef_search=24)[1])
    assert (ids[:, 0] == np.arange(512)).mean() >= 0.95


def _rewrite_cfg(path, key, extra):
    z = dict(np.load(path, allow_pickle=False))
    cfg = json.loads(str(z[key]))
    cfg.update(extra)
    z[key] = json.dumps(cfg)
    np.savez(path, **z)


def test_pq_index_saved_with_pallas_scan_loads(tmp_path, rng):
    """A PQFlatIndex snapshot carrying the removed fused-scan options
    (scan="pallas" and its knobs) loads and searches on the remaining
    path, with the same results."""
    from zvdb_tpu import PQConfig, PQFlatIndex

    x = rng.standard_normal((2000, 32)).astype(np.float32)
    idx = PQFlatIndex(PQConfig(dim=32, n_sub=8, train_sample=2000))
    idx.build(x)
    path = str(tmp_path / "pq.npz")
    idx.save(path)
    _rewrite_cfg(path, "cfg", dict(
        scan="pallas", scan_precision="int8", l_bins=1024, per_bin=2,
        pallas_chunk=1024, pallas_bq=512, seg_rows=1_048_576))
    back = PQFlatIndex.load(path)
    np.testing.assert_array_equal(np.asarray(back.search(x[:20], 5)[1]),
                                  np.asarray(idx.search(x[:20], 5)[1]))


def test_flat_config_from_dict_drops_removed_options():
    from zvdb_tpu import FlatConfig
    from zvdb_tpu.utils.config import config_from_dict

    cfg = config_from_dict(FlatConfig, dict(dim=8, scan="xla",
                                            removed_knob=3))
    assert cfg == FlatConfig(dim=8)
