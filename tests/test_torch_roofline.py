"""The port's roofline and dry-run tools, on the CPU.

* ``launch.roofline.model_flops`` equals the reference's for every
  (arch, cell); ``launch.op_analysis._ring_bytes`` equals the reference
  HLO parser's for every collective kind, and the counter gives
  ``compat.psum`` of a 4 KB f32 row over 4 ranks the reference test's
  2 x (3/4) x 4096 wire bytes (``tests/test_hlo_analysis.py`` case 3).
* ``attention_work``'s closed form equals a position-by-position count.
* On a reduced gemma2 (2 layers, d 64, window 6) the counted products of
  a forward are exactly 2 x tokens x (the projection and unembedding
  parameters), a prefill's the same with the unembedding at the last
  position only; the attention's count is ``attention_work``'s formula;
  a train step's FLOPs are 3x the forward's (with remat, more, up to the
  blocks' forward once more); and the CPU
  and ``meta`` counts are equal for train, prefill and decode.
* ``dryrun.run_cell`` at full size on ``meta`` (gemma2-9b train_4k
  single, kimi-k2 decode_32k multi, jamba-1.5-large long_500k single,
  whisper-tiny prefill_32k single): the config's parameter counts, the
  argument bytes per device equal to a sum over the specs, and every
  tensor of the trace on ``meta`` (nothing allocated).
"""
import importlib
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as j_hlo  # noqa: E402

from repro_torch import compat as C  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, roofline  # noqa: E402
from repro_torch.launch import shapes as t_shapes  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.models.sharding import unsharded  # noqa: E402

B, S = 2, 16
CFG = t_reduced(t_configs.get("gemma2_9b"), window=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def j_roofline():
    """The reference's ``launch.roofline``, whose import sets
    ``XLA_FLAGS`` for its own CLI: restored at once, so this process's
    JAX keeps its devices."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.roofline")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_model_flops_equal_the_reference_for_every_cell(j_roofline):
    from repro import configs as j_configs
    from repro.launch import shapes as j_shapes
    cells = list(t_shapes.all_cells())
    assert len(cells) == len(list(j_shapes.all_cells())) == 32
    for arch, cell in cells:
        want = j_roofline.model_flops(j_configs.get(arch),
                                      j_shapes.shape(cell.name))
        assert roofline.model_flops(t_configs.get(arch), cell) == want, \
            (arch, cell.name)


@pytest.mark.parametrize("kind", op_analysis.COLLECTIVES)
def test_ring_bytes_equal_the_reference(kind):
    for n in (1, 2, 4, 16):
        for size in (0, 1, 4096, 3 * 2 ** 30 + 7):
            assert op_analysis._ring_bytes(kind, size, n) == \
                j_hlo._ring_bytes(kind, size, n), (kind, size, n)


def test_psum_of_a_4kb_row_over_4_ranks_is_the_reference_tests_wire():
    mesh = C.EmulatedMesh((4,), ("d",))
    ranks = C.Ranks.of(mesh, ["d"])
    x = C.to_ranks(torch.ones(4, 1024), ranks, C.P("d", None))
    with op_analysis.OpCounter() as c:
        out = C.psum(x.sum(ranks.n, keepdim=True), ranks, "d")
    assert out.shape == (1, 1, 1024)
    assert c.cost.coll_bytes == {"all-reduce": 2 * 0.75 * 4096}
    assert c.cost.coll_count == {"all-reduce": 1}
    assert c.cost.coll_detail == [("all-reduce", (1, 1024), 4,
                                   2 * 0.75 * 4096)]


@pytest.mark.parametrize("fn,kind,local,n", [
    (lambda x, r: C.psum_scatter(x, r, "d", 1), "reduce-scatter",
     (1, 256), 4),
    (lambda x, r: C.all_gather(x, r, "d", 1), "all-gather", (1, 4096), 4),
    (lambda x, r: C.all_to_all(x, r, "d", 1, 1, tiled=True), "all-to-all",
     (1, 1024), 4),
    (lambda x, r: C.ppermute(x, r, "d", [(i, (i + 1) % 4)
                                         for i in range(4)]),
     "collective-permute", (1, 1024), 4),
])
def test_each_collective_reports_its_kind_and_one_ranks_result(fn, kind,
                                                                local, n):
    mesh = C.EmulatedMesh((4,), ("d",))
    ranks = C.Ranks.of(mesh, ["d"])
    x = C.to_ranks(torch.ones(4, 1024), ranks, C.P("d", None))
    with op_analysis.OpCounter() as c:
        fn(x, ranks)
    size = math.prod(local) * 4
    assert c.cost.coll_detail == [
        (kind, local, n, op_analysis._ring_bytes(kind, size, n))]


def _attention_work_plain(b, sq, hq, skv, causal, window, q_offset, kv_len):
    """Query by query: the keys each sees and their span."""
    kvl = skv if kv_len is None else min(skv, kv_len)
    pairs, los, his = 0, [], []
    for i in range(sq):
        s = i + q_offset
        hi = min(kvl, s + 1) if causal else kvl
        lo = max(0, s - window + 1) if window is not None else 0
        if hi > lo:
            pairs += hi - lo
            los.append(lo)
            his.append(hi)
    return b * hq * pairs, (max(his) - min(los)) if his else 0


def test_attention_work_closed_form_equals_a_plain_count():
    import random
    rnd = random.Random(0)
    cases = [(1, 8192, 16, 8192, True, None, 0, None),
             (1, 8192, 16, 8192, True, 4096, 0, None),
             (4, 1, 16, 8208, False, 4096, 8207, 8208),
             (1, 1000, 16, 1300, True, 4096, 300, None),
             (1, 0, 4, 10, True, None, 0, None),
             (1, 5, 2, 10, True, 3, 20, 12)]
    for _ in range(400):
        skv = rnd.randint(1, 90)
        cases.append((rnd.randint(1, 3), rnd.randint(0, 70),
                      rnd.randint(1, 4), skv, rnd.random() < 0.7,
                      rnd.choice([None, 1, 2, 5, 17, 64]),
                      rnd.randint(0, 100),
                      rnd.choice([None, rnd.randint(0, 110)])))
    for case in cases:
        assert op_analysis.attention_work(*case) == \
            _attention_work_plain(*case), case


def _params_and_batch(device="cpu"):
    cell = ShapeCell("t", "train", S, B)
    _, (params, _, batch), _, _ = t_steps.input_specs(
        "gemma2_9b", cell, unsharded(), cfg=CFG, device=device)
    return params, batch


def _projection_params(params) -> int:
    return sum(t.numel() for t in leaves(params["blocks"]) if t.ndim == 3)


def _attention_formula(seq_q, q_offset=0, kv_len=None, skv=None,
                       causal=True) -> int:
    total = 0
    for j in range(CFG.n_layers):
        window = CFG.window if CFG.is_local_layer(j) else None
        pairs, _ = op_analysis.attention_work(
            B, seq_q, CFG.n_heads, skv or seq_q, causal, window, q_offset,
            kv_len)
        total += 4 * CFG.head_dim * pairs
    return total


def test_forward_products_are_two_flops_a_parameter_a_token():
    params, batch = _params_and_batch()
    with op_analysis.OpCounter() as c:
        TT.forward(params, CFG, batch)
    unembed = params["embed"].numel()                    # tied
    products = c.cost.flops - c.cost.attention_flops
    assert products == 2 * B * S * (_projection_params(params) + unembed)
    assert c.cost.attention_flops == _attention_formula(S)
    assert c.cost.flops_by_dtype == {"bfloat16": c.cost.flops}


def test_prefill_products_take_the_unembedding_at_the_last_position():
    params, batch = _params_and_batch()
    with op_analysis.OpCounter() as c:
        TT.prefill(params, CFG, batch)
    products = c.cost.flops - c.cost.attention_flops
    assert products == 2 * B * S * _projection_params(params) \
        + 2 * B * params["embed"].numel()
    assert c.cost.attention_flops == _attention_formula(S)


def test_decode_attention_counts_the_visible_keys():
    cell = ShapeCell("d", "decode", S, B)
    fn, args, _, _ = t_steps.input_specs("gemma2_9b", cell,
                                         unsharded(), cfg=CFG,
                                         device="cpu")
    with op_analysis.OpCounter() as c:
        fn(*args)
    assert args[1].pos == S - 1
    assert c.cost.attention_flops == _attention_formula(
        1, q_offset=S - 1, kv_len=S, skv=S, causal=False)


def test_a_train_step_counts_three_forwards():
    """Forward, then two products of each product's shape in the
    backward and twice the attention's in its formula: exactly 3x the
    forward's FLOPs (the optimizer multiplies no matrices)."""
    params, batch = _params_and_batch()
    opt = t_steps.make_optimizer("gemma2_9b")
    with op_analysis.OpCounter() as fwd:
        TT.forward(params, CFG, batch)
    with op_analysis.OpCounter() as c:
        t_steps.make_train_step(CFG, opt, remat=False)(
            params, opt.init(params), batch)
    assert c.cost.flops == 3 * fwd.cost.flops
    assert c.cost.attention_flops == 3 * fwd.cost.attention_flops


def test_remat_recomputes_the_blocks_until_the_backward_has_its_inputs():
    """With remat (``input_specs``' step) each block's forward runs again
    in the backward, the attention whole; the recompute stops once every
    tensor the backward saved is back (``torch.utils.checkpoint``'s
    early stop), so the last products of a block may not rerun. The
    count is what runs: more than 3x the forward, at most 3x plus the
    blocks' forward once more."""
    params, batch = _params_and_batch()
    opt = t_steps.make_optimizer("gemma2_9b")
    with op_analysis.OpCounter() as fwd:
        TT.forward(params, CFG, batch)
    with op_analysis.OpCounter() as c:
        t_steps.make_train_step(CFG, opt)(params, opt.init(params), batch)
    unembed = 2 * B * S * params["embed"].numel()
    assert 3 * fwd.cost.flops < c.cost.flops <= \
        4 * fwd.cost.flops - unembed
    assert c.cost.attention_flops == 4 * fwd.cost.attention_flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cpu_and_meta_counts_are_equal(kind):
    cell = ShapeCell(kind, kind, S, B)
    cpu = dryrun.trace_cell("gemma2_9b", cell, "one", cfg=CFG, device="cpu")
    meta = dryrun.trace_cell("gemma2_9b", cell, "one", cfg=CFG,
                             device="meta")
    assert cpu.cost.devices == {"cpu"} and meta.cost.devices == {"meta"}
    for f in ("flops", "bytes", "attention_flops", "flops_by_dtype",
              "coll_bytes"):
        assert getattr(cpu.cost, f) == getattr(meta.cost, f), f
    assert cpu.argument_bytes == meta.argument_bytes
    assert cpu.output_bytes == meta.output_bytes


def _spec_bytes(tree, specs, mesh) -> int:
    """Per-device bytes, leaf by leaf: each dimension over the product
    of the mesh axes its spec entry names (rounded up)."""
    if isinstance(specs, C.P) or specs is None:
        if not isinstance(tree, torch.Tensor):
            return 0
        entries = list(specs or ()) + [None] * tree.ndim
        n = tree.element_size()
        for d, e in zip(tree.shape, entries):
            names = [] if e is None else [e] if isinstance(e, str) else e
            n *= -(-d // math.prod(mesh.shape[a] for a in names))
        return n
    if isinstance(specs, dict):
        return sum(_spec_bytes(tree[k], v, mesh) for k, v in specs.items())
    return sum(_spec_bytes(t, s, mesh) for t, s in zip(tree, specs))


@pytest.mark.parametrize("arch,shape_name,mesh_kind", [
    ("gemma2_9b", "train_4k", "single"), ("kimi_k2", "decode_32k", "multi"),
    ("jamba_15_large", "long_500k", "single"),
    ("whisper_tiny", "prefill_32k", "single")])
def test_run_cell_at_full_size_allocates_nothing(arch, shape_name,
                                                 mesh_kind):
    r = dryrun.run_cell(arch, shape_name, mesh_kind)
    cfg = t_configs.get(arch)
    assert r["status"] == "ok" and r["tensor_devices"] == ["meta"]
    assert r["params"] == cfg.param_count()
    assert r["active_params"] == cfg.active_param_count()
    cell = t_shapes.shape(shape_name)
    plan, mesh, n_dev = dryrun.cell_plan(mesh_kind, cell)
    _, args, specs, _ = t_steps.input_specs(arch, cell, plan)
    assert all(t.device.type == "meta" for t in leaves(args)
               if isinstance(t, torch.Tensor))
    assert r["memory"]["argument_bytes"] == _spec_bytes(args, specs, mesh)
    assert r["memory"]["temp_bytes"] is None
    assert r["devices"] == n_dev == mesh.size
    assert r["flops"] == r["flops_global"] / n_dev > 0
    assert not torch.cuda.is_initialized()


def test_analyze_cell_reports_the_h100_terms():
    r = roofline.analyze_cell("gemma2_9b", "train_4k", "single")
    n = r["devices"]
    assert r["flops_per_dev"] == r["flops_global"] / n
    assert r["t_compute_s"] == r["flops_global"] / n / 989e12
    assert r["t_memory_s"] == r["bytes_per_dev"] / 3.35e12
    assert r["t_collective_s"] == r["coll_bytes_per_dev"] / 450e9
    assert r["coll_implied"]["all-gather"] > 0          # FSDP gathers
    assert r["model_flops_per_dev"] == roofline.model_flops(
        t_configs.get("gemma2_9b"), t_shapes.shape("train_4k")) / n
    assert 0 < r["useful_ratio"] < 1     # remat recomputes the forward
    assert r["dominant"] in ("compute", "memory", "collective")


def test_counter_hooks_cost_nothing_without_a_counter():
    """With no counter on, the hooks the kernels and the collectives call
    return at once: ``uncounted`` is a null context, the counts add to
    nothing. With one on, ``uncounted`` pauses it."""
    import contextlib

    from repro_torch import _cost
    assert not _cost._ACTIVE
    assert isinstance(_cost.uncounted(), contextlib.nullcontext)
    q = torch.zeros(1, 4, 2, 8)
    _cost.count_attention(q, q, causal=True, window=None, q_offset=0,
                          kv_len=None)
    _cost.count_collective("all-reduce", q, 1, 4)
    a = torch.ones(3, 5)
    with op_analysis.OpCounter() as c:
        assert not isinstance(_cost.uncounted(), contextlib.nullcontext)
        with _cost.uncounted():
            a @ a.T
        assert c.cost.flops == 0
        a @ a.T
    assert c.cost.flops == 2 * 3 * 5 * 3 and not _cost._ACTIVE


def test_kernels_and_collectives_do_not_import_the_launch_tools():
    import subprocess
    import sys
    code = ("import sys, repro_torch.kernels.ops, repro_torch.kernels.flash,"
            " repro_torch.compat; print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.launch')))")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in ("src", os.environ.get("PYTHONPATH")) if p)}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_roofline_cli_is_the_dryrun_sweep(tmp_path, capsys):
    """The roofline CLI runs ``dryrun``'s sweep, one trace a cell, whose
    record carries the dry-run's and the roofline's fields (equal to
    ``analyze_cell``'s); ``--table`` renders it."""
    argv = ["--arch", "gemma2_9b", "--shape", "train_4k", "--mesh",
            "single", "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as done:
        roofline.main(argv)
    assert done.value.code == 0
    import json
    rec = json.loads(
        (tmp_path / "gemma2_9b__train_4k__single.json").read_text())
    want = roofline.analyze_cell("gemma2_9b", "train_4k", "single")
    for key in ("flops_global", "bytes_per_dev", "t_compute_s",
                "t_memory_s", "t_collective_s", "dominant", "useful_ratio",
                "roofline_fraction", "mem_per_dev", "model_flops_global"):
        assert rec[key] == want[key], key
    assert rec["memory"]["argument_bytes"] == \
        want["mem_per_dev"]["argument_bytes"]
    capsys.readouterr()
    roofline.main(["--table", "--out", str(tmp_path)])
    table = capsys.readouterr().out.splitlines()
    assert len(table) == 3 and table[2].startswith(
        "| gemma2_9b | train_4k | single |")
