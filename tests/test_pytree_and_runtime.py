"""The pytree dataclass helper (utils/pytree.py), the process set-up helpers
(utils/runtime.py), retired config keys, and the package's independence
from flax and PyYAML."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from badger_amcl.config import RETIRED_PARAMS, AMCLConfig
from badger_amcl.utils import runtime
from badger_amcl.utils.pytree import pytree_dataclass, static_field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytree_dataclass
class _Rec:
    x: jnp.ndarray
    y: jnp.ndarray = 0.0
    n: int = static_field(default=3)


def test_pytree_flatten_leaves_and_static_aux():
    r = _Rec(x=jnp.arange(3.0), y=jnp.float32(2.0), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(r)
    assert len(leaves) == 2  # the static field is no leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.n == 5 and np.array_equal(back.x, r.x)
    other = jax.tree_util.tree_structure(_Rec(x=jnp.arange(3.0), n=6))
    assert other != treedef  # the static value is part of the structure


def test_pytree_replace_and_frozen():
    r = _Rec(x=jnp.zeros(2))
    r2 = r.replace(y=jnp.float32(4.0), n=7)
    assert float(r2.y) == 4.0 and r2.n == 7 and r.n == 3
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.n = 1


def test_pytree_tree_map_and_vmap():
    r = _Rec(x=jnp.ones((4, 2)), y=jnp.arange(4.0), n=2)
    doubled = jax.tree.map(lambda a: 2 * a, r)
    assert doubled.n == 2 and float(doubled.y[3]) == 6.0
    out = jax.vmap(lambda t: t.x.sum() * t.n + t.y)(r)
    np.testing.assert_allclose(out, [4.0, 5.0, 6.0, 7.0])


def test_pytree_static_change_retraces_leaf_change_does_not():
    traces = []

    @jax.jit
    def f(r):
        traces.append(r.n)
        return r.x * r.n

    f(_Rec(x=jnp.ones(2), n=2))
    f(_Rec(x=jnp.full(2, 5.0, jnp.float32), n=2))
    assert traces == [2]
    f(_Rec(x=jnp.ones(2), n=3))
    assert traces == [2, 3]


def _cache_dir_after(monkeypatch, env_value):
    if env_value is None:
        monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(runtime.CACHE_ENV, env_value)
    before = jax.config.jax_compilation_cache_dir
    try:
        returned = runtime.enable_compile_cache()
        return returned, jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    returned, configured = _cache_dir_after(monkeypatch, None)
    assert returned == configured == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    returned, configured = _cache_dir_after(monkeypatch, str(tmp_path))
    assert returned == str(tmp_path)
    assert configured == before  # nothing set in code: JAX reads the variable


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        runtime.require_gpu(jax.devices("cpu")[0])


@pytest.mark.parametrize("key, value", [("compute_backend", "pallas_corr"),
                                        ("beam_range_image_bins", 256)])
def test_old_config_with_retired_key_loads_with_warning(key, value):
    warnings = []
    cfg = AMCLConfig.from_params({key: value, "max_particles": 4000},
                                 warn=lambda *a: warnings.append(a))
    assert key in RETIRED_PARAMS
    assert cfg.max_particles == 4000 and not hasattr(cfg, key)
    assert len(warnings) == 1 and "retired" in warnings[0][0]
    assert warnings[0][1] == [key]


_BLOCKED_RUN = """
import runpy, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "yaml"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, _Block())
for name in ("flax", "yaml"):
    try:
        __import__(name)
    except ImportError:
        pass
    else:
        sys.exit(name + " import was not blocked")
sys.argv = ["badger_amcl"] + sys.argv[1:]
runpy.run_module("badger_amcl", run_name="__main__")
"""


def test_cli_runs_without_flax_and_yaml(tmp_path):
    """The package imports and the CLI runs its simulator with `flax` and
    `yaml` unimportable, as on a machine that has neither."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, "--sim", "--steps", "2", "--seed", "0",
         "--config", os.path.join(REPO, "examples", "amcl_2d.yaml")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX device: cpu" in proc.stderr
    assert (tmp_path / "badger_amcl_saved_pose.yaml").exists()
