"""Serving from a checkpoint: the port's ``launch.serve.restore_params``
(and the CLI's ``--restore-dir`` / ``--no-node-cache``) against the
reference's, on the CPU.

The reference writes checkpoints of reduced gemma2-9b's f32 parameters
(``repro.checkpoint.save_checkpoint``, TAM, 8 ranks on 2 nodes, 4 KiB
stripes over 4 aggregators) into a directory, steps 3 and 7; both
packages' ``restore_params`` read the newest through the planned
collective read (8 readers on 2 nodes, the striping from the manifest),
with the node cache on and off. Held exactly: every parameter bit for
bit, the step, every ``IOTimings`` field but the wall-clock
``plan_seconds``, and ``serve.generate``'s tokens from the restored
parameters.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.checkpoint import HostCollectiveIO as JIO  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.models.sharding import unsharded  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch._tree import leaves, leaves_with_paths, tree_map  # noqa
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

STEP = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A directory of two reference checkpoints of reduced gemma2 (steps
    3 and ``STEP``; the newer holds the parameters of seed 0, the older
    those of seed 1). Returns (dir, reference config, port config, the
    newer parameters as numpy)."""
    d = tmp_path_factory.mktemp("serve_ckpt")
    cfg_j = j_reduced(j_configs.get("gemma2_9b"))
    cfg_t = t_reduced(t_configs.get("gemma2_9b"))
    for seed, step in ((1, 3), (0, STEP)):
        params = jax.tree.map(np.asarray, JT.init_params(
            jax.random.PRNGKey(seed), cfg_j, dtype=jnp.float32))
        j_save(params, d / f"ckpt_{step:08d}", step=step,
               io=JIO(n_ranks=8, n_nodes=2, stripe_size=4096,
                      stripe_count=4), method="tam")
    return d, cfg_j, cfg_t, params


def _same(x, y) -> bool:
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("node_cache", [True, False])
def test_restore_params_equals_the_reference(ckpt_dir, node_cache):
    d, cfg_j, cfg_t, saved = ckpt_dir
    like_j = JT.init_params(jax.random.PRNGKey(5), cfg_j, dtype=jnp.float32)
    want, step_j, t_j = j_serve.restore_params(str(d), like_j,
                                               node_cache=node_cache)
    like_t = TT.init_params(5, cfg_t, dtype=torch.float32, device="cpu")
    got, step_t, t_t = t_serve.restore_params(str(d), like_t,
                                              node_cache=node_cache)
    assert step_t == step_j == STEP
    flat_j = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in leaves_with_paths(got)] == [
        jax.tree_util.keystr(kp) for kp, _ in flat_j]
    for (kp, w), g in zip(flat_j, leaves(got)):
        assert g.device.type == "cpu"
        assert _same(g, torch.from_numpy(np.array(w))), kp
    for w, g in zip(jax.tree.leaves(saved), leaves(got)):
        assert _same(g, torch.from_numpy(np.array(w)))
    for f in dataclasses.fields(t_j):
        if f.name != "plan_seconds":
            assert getattr(t_t, f.name) == getattr(t_j, f.name), f.name
    assert t_t.total == t_j.total
    assert t_t.read_bytes > 0
    assert (t_t.cache_hit_ratio > 0) == node_cache


def test_generate_after_the_restore_equals_the_reference(ckpt_dir):
    d, cfg_j, cfg_t, _ = ckpt_dir
    params_j, _, _ = j_serve.restore_params(
        str(d), JT.init_params(jax.random.PRNGKey(5), cfg_j,
                               dtype=jnp.float32))
    params_t, _, _ = t_serve.restore_params(
        str(d), TT.init_params(5, cfg_t, dtype=torch.float32, device="cpu"))
    prompts = np.random.default_rng(2).integers(
        0, cfg_j.vocab, size=(2, 6)).astype(np.int32)
    want = j_serve.generate(params_j, cfg_j, jnp.asarray(prompts), 5,
                            unsharded())
    got = t_serve.generate(params_t, cfg_t, torch.from_numpy(prompts), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_restore_params_lands_on_the_like_tree_and_without_checkpoints_raises(
        ckpt_dir, tmp_path):
    d, _, cfg_t, _ = ckpt_dir
    like = tree_map(torch.zeros_like,
                    TT.init_params(0, cfg_t, dtype=torch.float32,
                                   device="cpu"))
    got, _, _ = t_serve.restore_params(str(d), like)
    assert all(t.device.type == "cpu" for t in leaves(got))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        t_serve.restore_params(str(tmp_path), like)


@pytest.mark.parametrize("flag", [[], ["--no-node-cache"]])
def test_cli_serves_from_the_restore_dir(ckpt_dir, monkeypatch, capsys, flag):
    """``python -m repro_torch.launch.serve --restore-dir`` on the CPU:
    the restore's step and modeled time, then the generation."""
    d, *_ = ckpt_dir
    monkeypatch.setattr("sys.argv", [
        "serve", "--device", "cpu", "--gen", "3", "--prompt-len", "4",
        "--restore-dir", str(d), *flag])
    t_serve.main()
    out = capsys.readouterr().out
    assert f"restored step {STEP}: modeled" in out
    assert ("cache hit ratio 0.00" in out) == bool(flag)
    assert "generated (4, 4)" in out
