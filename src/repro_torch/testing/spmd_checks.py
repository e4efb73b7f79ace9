"""Mesh-path checks (the port of ``src/repro/testing/spmd_checks.py``).

    python -m repro_torch.testing.spmd_checks [--device cpu|cuda]

The reference's 17 checks, under its names, on its inputs (numpy,
``default_rng(0)``, its shapes), every rank a row of a tensor on one
device:

* the collective writes and reads through the rank-axis executor on a
  ``(node 2, lagg 2, lmem 2)`` grid: two-phase and TAM writes against
  ``write_reference`` with no drops, TAM with ``use_kernels=True`` (on
  the card the ``bitonic_sort`` and ``coalesce`` kernels), both reads,
  and a block pattern whose TAM write coalesces at least 4 requests
  into 1;
* ``two_layer_psum``, ``compressed_psum`` (int8 on the slow hop, within
  5e-2 of the sum, its residual nonzero) and ``two_layer_all_to_all``
  through ``compat.shard_map`` on an emulated ``(pod 2, ici 4)`` mesh;
* on an emulated ``(data 2, model 4)`` plan (``models.sharding``,
  ``launch.mesh``): the sharded MoE against the dense path in both
  forms, the aux loss, the sequence-sharded decode attention against
  the flash attention, and reduced glm4's loss sharded against local
  within 2e-3.

The reference draws the MoE, attention and model weights from JAX keys.
The MoE checks take its own draws, carried as arrays
(``moe_check_inputs.npz``: ``init_moe`` of ``PRNGKey(0)`` in f32 and the
tokens of ``PRNGKey(1)``), so ``moe_aux_close``, an approximation that
holds for some draws and not others, gives the reference's verdict on
the reference's inputs. The attention and glm4's weights come from CPU
``torch.Generator``s seeded as the reference's keys and are then moved
to the device, so the card and the CPU check the same inputs (the pairs
compared are both computed here, on the same draws), and the model's
tokens from numpy.
"""
from __future__ import annotations

import sys
from dataclasses import replace as dreplace
from pathlib import Path

import numpy as np

from repro_torch.testing import Checks, cli

# the reference's MoE parameters and tokens (see the docstring)
MOE_INPUTS = Path(__file__).with_name("moe_check_inputs.npz")


def _io_checks(check, dev) -> None:
    from repro_torch.core import (IOConfig, RankMesh, contiguous_layout,
                                  make_tam_write, make_twophase_write)
    from repro_torch.core.tam import make_tam_read
    from repro_torch.core.twophase import make_twophase_read, write_reference

    mesh = RankMesh(2, 2, 2)
    P_ranks, REQ_CAP, DATA_CAP, FILE_LEN = 8, 8, 64, 256
    layout = contiguous_layout(FILE_LEN, 2)
    rng = np.random.default_rng(0)
    slots = rng.permutation(FILE_LEN // 8)
    spr = len(slots) // P_ranks
    O = np.full((P_ranks, REQ_CAP), 2**31 - 1, np.int32)
    L = np.zeros((P_ranks, REQ_CAP), np.int32)
    C = np.zeros(P_ranks, np.int32)
    D = np.zeros((P_ranks, DATA_CAP), np.int32)
    for p in range(P_ranks):
        mine = np.sort(slots[p * spr:(p + 1) * spr])
        offs = (mine * 8).astype(np.int32)
        lens = rng.integers(1, 9, size=len(mine)).astype(np.int32)
        O[p, :len(offs)], L[p, :len(lens)], C[p] = offs, lens, len(offs)
        D[p, :lens.sum()] = rng.integers(1, 999, size=lens.sum())
    ref = write_reference(layout, O, L, C, D)
    cfg = IOConfig(req_cap=32, data_cap=DATA_CAP, coalesce_cap=32)

    def file_ok(f, want):
        return np.array_equal(f.cpu().numpy().reshape(-1), want)

    f, s = make_twophase_write(mesh, layout, cfg, device=dev)(O, L, C, D)
    check("twophase_write", file_ok(f, ref))
    f, s = make_tam_write(mesh, layout, cfg, device=dev)(O, L, C, D)
    check("tam_write", file_ok(f, ref))
    check("tam_no_drops", int(s["dropped_requests"]) == 0
          and int(s["dropped_elems"]) == 0)
    f, s = make_tam_write(mesh, layout, cfg, use_kernels=True,
                          device=dev)(O, L, C, D)
    check("tam_write_kernels", file_ok(f, ref))

    def payloads_ok(got):
        got = got.cpu().numpy()
        return all(np.array_equal(got[p][:L[p].sum()], D[p][:L[p].sum()])
                   for p in range(P_ranks))
    file2 = ref.reshape(2, -1)
    check("tam_read", payloads_ok(
        make_tam_read(mesh, layout, cfg, device=dev)(O, L, C, file2)))
    check("twophase_read", payloads_ok(
        make_twophase_read(mesh, layout, cfg, device=dev)(O, L, C, file2)))

    # block pattern: coalescing fires
    Ob = np.full((8, 8), 2**31 - 1, np.int32)
    Lb = np.zeros((8, 8), np.int32)
    for p in range(8):
        Ob[p, :4] = np.arange(4, dtype=np.int32) * 8 + p * 32
        Lb[p, :4] = 8
    Cb = np.full(8, 4, np.int32)
    Db = (np.arange(8 * DATA_CAP, dtype=np.int32).reshape(8, -1) % 97) + 1
    Db[:, 32:] = 0
    refb = write_reference(layout, Ob, Lb, Cb, Db)
    f, s = make_tam_write(mesh, layout, cfg, use_kernels=True,
                          device=dev)(Ob, Lb, Cb, Db)
    check("tam_block_write", file_ok(f, refb))
    check("tam_block_coalesce",
          int(s["requests_after_coalesce"]) * 4
          <= int(s["requests_before_coalesce"]))
    return rng


def _collective_checks(check, dev, rng) -> None:
    import torch

    from repro_torch.compat import EmulatedMesh, P, shard_map
    from repro_torch.core.hierarchical import (compressed_psum,
                                               two_layer_all_to_all,
                                               two_layer_psum)

    mesh2 = EmulatedMesh((2, 4), ("pod", "ici"))
    axes = ("pod", "ici")
    x = torch.from_numpy(rng.normal(size=(8, 33)).astype(np.float32)).to(dev)
    r2 = shard_map(
        lambda R, xs: two_layer_psum(xs.reshape(*xs.shape[:R.n], 33), R,
                                     "ici", "pod"),
        mesh2, (P(axes),), P(), axes)(x)
    check("two_layer_psum",
          torch.allclose(r2.reshape(33), x.sum(0), atol=1e-4))

    outc, nres = shard_map(
        lambda R, xs, res: compressed_psum(
            xs.reshape(*xs.shape[:R.n], 33), res.reshape(*res.shape[:R.n], 33),
            R, "ici", "pod"),
        mesh2, (P(axes), P(axes)), (P(), P(axes)), axes)(
            x, torch.zeros_like(x))
    want = x.sum(0)
    rel = float((outc.reshape(33) - want).abs().max() / want.abs().max())
    check("compressed_psum_int8", rel < 5e-2)
    check("compressed_psum_residual_nonzero", float(nres.abs().sum()) > 0)

    xa = torch.arange(8 * 8 * 5, dtype=torch.int32, device=dev).reshape(
        8, 8 * 5)
    ra = shard_map(
        lambda R, xs: two_layer_all_to_all(
            xs.reshape(*xs.shape[:R.n], 8, 5), R, "ici", "pod"),
        mesh2, (P(axes),), P(axes), axes)(xa)
    ref_a = np.transpose(xa.cpu().numpy().reshape(8, 8, 5),
                         (1, 0, 2)).reshape(8, 8 * 5)
    check("two_layer_all_to_all",
          np.array_equal(ra.cpu().numpy().reshape(8, -1), ref_a))


def _model_checks(check, dev) -> None:
    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.compat import EmulatedMesh
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT
    from repro_torch.models.config import reduced
    from repro_torch.models.sharding import ShardingPlan, unsharded
    from repro_torch.launch.mesh import make_plan

    def gen(seed):   # on the CPU: the same draws for every device
        g = torch.Generator()
        g.manual_seed(seed)
        return g

    def randn(shape, seed):
        return torch.randn(shape, generator=gen(seed)).to(dev)

    mesh3 = EmulatedMesh((2, 4), ("data", "model"))
    cfg_m = reduced(configs.get("llama4_maverick"))
    cfg_m = dreplace(cfg_m, moe=dreplace(cfg_m.moe, capacity_factor=4.0),
                     d_model=32, vocab=256)
    with np.load(MOE_INPUTS) as a:   # the reference's own draws
        moe_p = {k: torch.from_numpy(a[k]).to(dev)
                 for k in ("router", "wi", "wg", "wo")}
        x = torch.from_numpy(a["x"]).to(dev)
    dense_out, dense_aux = ML.moe(moe_p, x, cfg_m, unsharded())
    plan3 = make_plan(mesh3, shard_seq=True)
    sh_out, sh_aux = ML.moe(moe_p, x, cfg_m, plan3)
    check("moe_sharded_matches_dense",
          torch.allclose(sh_out, dense_out, rtol=2e-4, atol=2e-4))
    # the per-shard aux is an E[me_loc * ce_loc] approximation of the
    # global E[me] * E[ce]: they agree in expectation, not exactly
    check("moe_aux_close",
          abs(float(sh_aux) - float(dense_aux)) < 0.25 * float(dense_aux)
          + 0.05)

    plan3d = ShardingPlan(mesh=mesh3, data_axes=("data",),
                          model_axis="model", shard_seq=False)
    sh_out2, _ = ML.moe(moe_p, x[:, :1], cfg_m, plan3d)
    dense2, _ = ML.moe(moe_p, x[:, :1], cfg_m, unsharded())
    check("moe_decode_path_matches_dense",
          torch.allclose(sh_out2, dense2, rtol=2e-4, atol=2e-4))

    B, S, HQ, HKV, HD = 4, 64, 8, 2, 16
    q = randn((B, 1, HQ, HD), 2)
    kc = randn((B, S, HKV, HD), 3)
    vc = randn((B, S, HKV, HD), 4)
    pos = 37
    ref_o = ML.flash_attention(q, kc, vc, causal=False, window=None,
                               logit_cap=None, q_offset=pos, kv_len=pos + 1)
    got = ML.decode_attention_sharded(q, kc, vc, cache_pos=pos, window=None,
                                      logit_cap=None, plan=plan3d)
    check("decode_attention_sharded",
          torch.allclose(got.reshape(B, 1, HQ, HD), ref_o, rtol=2e-3,
                         atol=2e-3))

    # a train step's loss under the production partitioning (2 x 4)
    cfg_t = reduced(configs.get("glm4_9b"))
    params = tree_map(lambda t: t.to(dev), MT.init_params(
        5, cfg_t, dtype=torch.float32, device="cpu"))
    rng = np.random.default_rng(0)
    batch = {name: torch.from_numpy(
        rng.integers(0, cfg_t.vocab, size=(4, 16)).astype(np.int32)).to(dev)
        for name in ("tokens", "labels")}
    loss_sharded = MT.loss_fn(params, cfg_t, batch, plan=plan3)
    loss_local = MT.loss_fn(params, cfg_t, batch, plan=unsharded())
    check("sharded_loss_matches_local",
          abs(float(loss_sharded) - float(loss_local)) < 2e-3)


def run(device=None, out=None) -> Checks:
    """Every check on ``device`` (the card unless ``"cpu"``)."""
    import torch

    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    check = Checks(out)
    with torch.no_grad():
        rng = _io_checks(check, dev)
        _collective_checks(check, dev, rng)
        _model_checks(check, dev)
    return check


if __name__ == "__main__":
    sys.exit(cli(run, "The port's mesh-path checks."))
