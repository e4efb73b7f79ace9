"""The port's training path against the reference's, on the CPU.

Model: reduced gemma2-9b (its softcaps and local/global alternation),
with the window cut to 6 so that 16 tokens cross it (``reduced`` keeps
4096), the reference's f32 parameters carried over by
``weights.params_from_numpy``. Tokens come from the data pipeline, the
same numpy stream in both packages. Tolerances, each stated where used:

* ``loss_fn`` and every gradient leaf: rtol = atol = 2e-3, the repo's
  model tolerance (``tests/test_torch_models.py``); the gradient leaves
  match by path, so the leaf order is held too;
* ``adamw`` (bf16 moments) and ``adafactor`` over three updates of
  seeded trees: parameters at rtol = atol = 1e-5, f32 state at 1e-5,
  bf16 moments within one bf16 ulp (rtol 8e-3);
* ``warmup_cosine``: rtol 1e-6; the batches: equal;
* a few ``TrainLoop`` steps against the reference's jitted step: each
  loss at rtol 2e-3, the parameters after the steps at rtol = atol =
  2e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro import optim as j_optim  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokenPipeline as JPipeline  # noqa: E402
from repro.data import make_batch_iterator as j_iterator  # noqa: E402
from repro.launch import shapes as j_shapes  # noqa: E402
from repro.launch.steps import make_optimizer as j_make_optimizer  # noqa
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch._tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.data import make_batch_iterator  # noqa: E402
from repro_torch.launch import shapes as t_shapes  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch.train import build_training  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 16
OVER = {"window": 6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(kp), np.asarray(x, np.float32))
            for kp, x in flat]


@pytest.fixture(scope="module")
def model():
    cfg_j = j_reduced(j_configs.get("gemma2_9b"), **OVER)
    cfg_t = t_reduced(t_configs.get("gemma2_9b"), **OVER)
    params_j = JT.init_params(jax.random.PRNGKey(0), cfg_j,
                              dtype=jnp.float32)
    data = JDataConfig(vocab=cfg_j.vocab, seq=S, global_batch=B)
    return cfg_j, cfg_t, params_j, data


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("step", [0, 1, 7])
def test_batches_equal_array_for_array(model, step):
    *_, data = model
    want = JPipeline(data).batch_at(step)
    got = SyntheticTokenPipeline(DataConfig(**vars(data)),
                                 device="cpu").batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_batch_iterators_give_the_same_stream(model):
    *_, data = model
    cfg = DataConfig(**vars(data))
    ours = make_batch_iterator(cfg, start_step=3, device="cpu")
    theirs = j_iterator(data, start_step=3)
    for _ in range(3):
        got, want = next(ours), next(theirs)
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])


# ---------------------------------------------------------------- loss
def test_loss_and_every_gradient_leaf_match_the_reference(model):
    cfg_j, cfg_t, params_j, data = model
    batch = JPipeline(data).batch_at(0)
    loss_j, grads_j = jax.value_and_grad(JT.loss_fn)(
        params_j, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()})
    params_t = params_from_numpy(_np(params_j), device="cpu")
    live = [p.requires_grad_(True) for p in leaves(params_t)]
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t = TT.loss_fn(params_t, cfg_t, batch_t)
    grads_t = torch.autograd.grad(loss_t, live)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **MODEL_TOL)
    want = _paths(grads_j)
    got = [p for p, _ in leaves_with_paths(params_t)]
    assert got == [p for p, _ in want]
    for (path, w), g in zip(want, grads_t):
        np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL, err_msg=path)


def test_remat_gives_the_same_loss_and_gradients(model):
    _, cfg_t, params_j, data = model
    batch_t = {k: torch.from_numpy(v)
               for k, v in JPipeline(data).batch_at(1).items()}
    out = []
    for remat in (False, True):
        params_t = params_from_numpy(_np(params_j), device="cpu")
        live = [p.requires_grad_(True) for p in leaves(params_t)]
        loss = TT.loss_fn(params_t, cfg_t, batch_t, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, live)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_padded_vocab_is_masked_out_of_the_loss():
    """vocab 250 pads to 256: the port masks the pad columns as the
    reference does."""
    cfg_j = j_reduced(j_configs.get("gemma2_9b"), vocab=250, **OVER)
    cfg_t = t_reduced(t_configs.get("gemma2_9b"), vocab=250, **OVER)
    assert cfg_t.padded_vocab == 256
    params_j = JT.init_params(jax.random.PRNGKey(1), cfg_j,
                              dtype=jnp.float32)
    batch = JPipeline(JDataConfig(vocab=250, seq=S,
                                  global_batch=B)).batch_at(2)
    want = JT.loss_fn(params_j, cfg_j,
                      {k: jnp.asarray(v) for k, v in batch.items()})
    got = TT.loss_fn(params_from_numpy(_np(params_j), device="cpu"), cfg_t,
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), **MODEL_TOL)


# ---------------------------------------------------------------- optim
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"blocks": [{"w": rng.standard_normal((6, 5)).astype(np.float32),
                        "b": rng.standard_normal(5).astype(np.float32)}
                       for _ in range(2)],
            "stack": rng.standard_normal((2, 4, 3)).astype(np.float32),
            "scale": rng.standard_normal(()).astype(np.float32)}


def _close_state(got, want, path):
    w = np.asarray(want)
    if w.dtype.name == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(),
                                   w.astype(np.float32), rtol=8e-3,
                                   atol=1e-6, err_msg=path)
    elif w.dtype == np.int32:
        assert got.dtype == torch.int32 and int(got) == int(w), path
    else:
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("name", ["adamw", "adamw_noclip", "adafactor"])
def test_optimizers_match_the_reference(name):
    make = {"adamw": lambda m: m.adamw(),
            "adamw_noclip": lambda m: m.adamw(clip_norm=None,
                                              weight_decay=0.0),
            "adafactor": lambda m: m.adafactor(weight_decay=0.01)}[name]
    opt_j, opt_t = make(j_optim), make(t_optim)
    params_j = jax.tree.map(jnp.asarray, _opt_tree(0))
    params_t = params_from_numpy(_opt_tree(0), device="cpu")
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    for i in range(3):
        grads = _opt_tree(10 + i)
        lr = 1e-2 * (i + 1)
        params_j, state_j = opt_j.update(
            jax.tree.map(jnp.asarray, grads), state_j, params_j, lr)
        params_t, state_t = opt_t.update(
            params_from_numpy(grads, device="cpu"), state_t, params_t, lr)
    for (path, w), (tpath, g) in zip(_paths(params_j),
                                     leaves_with_paths(params_t)):
        assert path == tpath
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    flat, _ = jax.tree_util.tree_flatten_with_path(state_j)
    got = leaves_with_paths(state_t)
    assert [p for p, _ in got] == [jax.tree_util.keystr(kp) for kp, _ in flat]
    for (kp, w), (path, g) in zip(flat, got):
        _close_state(g, w, path)
    assert state_t["step"].dtype == torch.int32 and state_t["step"].dim() == 0


def test_warmup_cosine_matches_the_reference():
    want = j_optim.warmup_cosine(3e-3, warmup=20, total=200)
    got = t_optim.warmup_cosine(3e-3, warmup=20, total=200)
    for step in (0, 1, 10, 19, 20, 21, 100, 199, 200, 250):
        np.testing.assert_allclose(
            float(got(torch.tensor(step, dtype=torch.int32))),
            float(want(jnp.int32(step))), rtol=1e-6, err_msg=str(step))
    assert float(got(5)) == pytest.approx(float(want(5)), rel=1e-6)


def test_global_norm_matches_the_reference():
    tree = _opt_tree(3)
    np.testing.assert_allclose(
        float(t_optim.global_norm(params_from_numpy(tree, device="cpu"))),
        float(j_optim.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6)


# ---------------------------------------------------------------- shapes
def test_shape_cells_are_the_reference_s():
    assert [vars(c) for c in t_shapes.SHAPES] == \
        [vars(c) for c in j_shapes.SHAPES]
    assert t_shapes.ADAFACTOR_ARCHS == j_shapes.ADAFACTOR_ARCHS
    assert [(a, c.name, s) for a, c, s in t_shapes.all_cells(True)] == \
        [(a, c.name, s) for a, c, s in j_shapes.all_cells(True)]
    assert t_shapes.shape("train_4k").seq == 4096
    tree = _opt_tree(0)
    for arch in ("gemma2_9b", "kimi_k2"):       # adamw, adafactor
        got = t_steps.make_optimizer(arch).init(
            params_from_numpy(tree, device="cpu"))
        want = j_make_optimizer(arch).init(jax.tree.map(jnp.asarray, tree))
        assert [p for p, _ in leaves_with_paths(got)] == [
            jax.tree_util.keystr(kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(want)[0]]


# ---------------------------------------------------------------- loop
def _reference_losses(cfg_j, params_j, data, steps, lr):
    """The reference CLI's step (launch/train.py), jitted, over the
    pipeline's batches."""
    opt = j_make_optimizer("gemma2_9b")
    lr_fn = j_optim.warmup_cosine(lr, warmup=20, total=steps)

    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(JT.loss_fn)(params, cfg_j, batch)
        params, opt_state = opt.update(grads, opt_state, params,
                                       lr_fn(opt_state["step"]))
        return params, opt_state, loss

    step_fn = jax.jit(train_step)
    params, opt_state = params_j, opt.init(params_j)
    pipe = JPipeline(data)
    losses = []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(step).items()}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
    return losses, params


def test_train_loop_steps_match_the_reference(model, tmp_path):
    cfg_j, cfg_t, params_j, data = model
    steps, lr = 4, 3e-3
    want_losses, want_params = _reference_losses(cfg_j, params_j, data,
                                                 steps, lr)
    run = build_training("gemma2_9b", cfg=cfg_t, steps=steps, batch=B,
                         seq=S, lr=lr, ckpt_dir=str(tmp_path),
                         ckpt_every=2, log_every=1, device="cpu")
    run.params = params_from_numpy(_np(params_j), device="cpu")
    run.opt_state = run.opt.init(run.params)
    loop = run.loop()
    params, opt_state, last = loop.run(run.params, run.opt_state)
    assert last == steps and int(opt_state["step"]) == steps
    np.testing.assert_allclose(loop.losses, want_losses, rtol=2e-3)
    for (path, w), g in zip(_paths(want_params), leaves(params)):
        np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL, err_msg=path)
    # the loop checkpointed at steps 2 and 4; step 4 restores exactly
    assert run.ckpt.latest_step() == 4
    got, step = run.ckpt.restore({"params": params, "opt": opt_state})
    assert step == 4
    for a, b in zip(leaves(got), leaves({"params": params,
                                         "opt": opt_state})):
        assert torch.equal(a, b)


def test_kill_restore_and_resume_equals_the_uninterrupted_run(model,
                                                              tmp_path):
    """The card run's scenario on the CPU: a host fails after the step-2
    checkpoint; find_restart_step, restore and a new loop from step 2
    give the uninterrupted run's losses and state, bit for bit."""
    from repro_torch.runtime import HeartbeatMonitor, find_restart_step
    _, cfg_t, params_j, _ = model

    def fresh(ckpt_dir, every):
        run = build_training("gemma2_9b", cfg=cfg_t, steps=4, batch=B, seq=S,
                             ckpt_dir=str(ckpt_dir), ckpt_every=every,
                             log_every=1, device="cpu")
        run.params = params_from_numpy(_np(params_j), device="cpu")
        run.opt_state = run.opt.init(run.params)
        return run

    control = fresh(tmp_path / "control", 10 ** 9)
    loop = control.loop()
    want_p, want_o, _ = loop.run(control.params, control.opt_state)
    want_losses = loop.losses

    run = fresh(tmp_path / "faulty", 2)
    monitor = HeartbeatMonitor(n_hosts=2, timeout_s=1e9)
    loop = run.loop(monitor)

    def on_step(step, loss):
        if step == 2:
            monitor.inject_failure(1)

    with pytest.raises(RuntimeError, match="host failure"):
        loop.run(run.params, run.opt_state, on_step=on_step)
    before = list(loop.losses)
    start = find_restart_step(run.ckpt.directory)
    assert start == 2
    state, step = run.ckpt.restore({"params": run.params,
                                    "opt": run.opt_state})
    assert step == 2
    resumed = run.loop()
    p, o, last = resumed.run(state["params"], state["opt"], start_step=2)
    assert last == 4
    assert before + resumed.losses == want_losses
    for a, b in zip(leaves({"p": p, "o": o}), leaves({"p": want_p,
                                                      "o": want_o})):
        assert torch.equal(a, b)
