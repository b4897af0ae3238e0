"""The port's mesh (``videop2p_tpu_torch/parallel``) against the unsharded
port and the JAX package, on the CPU in float32, ranks in spawned gloo
process groups (``tests/torch_dist.py``; JAX is imported inside the test
functions only, so the ranks load torch alone).

Covered: the sharded frame attention (frame-0 K/V broadcast) and GroupNorm
(per-frame slabs whole, frame-pooled slabs with all-reduced statistics)
and their gradients; ``param_shardings`` against JAX's specs and GEGLU's
matched split; "gspmd" against "psum_scatter"; the tiny UNet's forward on
(1,2,1), (1,1,2) and (1,2,2) meshes against JAX's (2e-4); the cached fast
edit on (1,2,1) against JAX's unsharded and (1,4,2)-sharded edits (2e-3,
stream 0 bit for bit); null-text on (1,2,1), every rank stopping at the
same inner steps; a Stage-1 step on (1,2,1) and (1,1,2) against the
unsharded step, the replicas' divergence 0.0.

Tolerances: float32 on both sides; a sharded run sums in another order
(the frame-pooled statistics, the gathered temporal K/V, the
row-parallel partial sums), ~1e-6 a forward.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_dist import frames_mesh, run_ranks

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

F = 4
SAMPLE = (1, F, 8, 8, 4)
PROMPTS = ["a rabbit is jumping on the grass", "a origami rabbit is jumping on the grass"]
CTRL = dict(is_replace_controller=False, cross_replace_steps=0.5, self_replace_steps=0.5,
            blend_words=(("rabbit",), ("rabbit",)),
            equalizer_params={"words": ["origami"], "values": [2]})
STEPS = 3


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=SAMPLE).astype(np.float32),
                text=rng.normal(size=(1, 77, 16)).astype(np.float32),
                cond=rng.normal(size=(2, 77, 16)).astype(np.float32),
                uncond=rng.normal(size=(77, 16)).astype(np.float32))


def _port_unet(sd):
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig

    m = UNet3DConditionModel(UNet3DConfig.tiny())
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m.eval()


def _setup(sd, spec):
    from videop2p_tpu_torch.cli.common import setup_mesh

    bundle = SimpleNamespace(unet=_port_unet(sd))
    mesh = setup_mesh(bundle, spec, F, device=torch.device("cpu"))
    return bundle.unet, mesh


# ----------------------------------------------------------- the wrappers --


def _wrappers_worker(rank, world, q, k, v, x5, x4, w, b):
    from videop2p_tpu_torch.ops.attention import dense_frame_attention
    from videop2p_tpu_torch.parallel import make_sharded_frame_attention_fn, make_sharded_group_norm_fn
    from videop2p_tpu_torch.parallel.mesh import frames_slice, gather_frames

    mesh = frames_mesh(2)
    out = {}
    # frame attention: this rank's frames; frame 0's K/V only on rank 0
    qt = frames_slice(torch.from_numpy(q), mesh).clone().requires_grad_(True)
    kt = torch.from_numpy(k if rank == 0 else k * 0 + 7.0).requires_grad_(True)
    vt = torch.from_numpy(v if rank == 0 else v * 0 - 3.0).requires_grad_(True)
    y = make_sharded_frame_attention_fn(mesh)(qt, kt, vt)
    assert torch.equal(y, dense_frame_attention(qt, torch.from_numpy(k), torch.from_numpy(v)))
    (y * torch.linspace(-1, 1, y.numel()).view(y.shape).narrow(1, 0, y.shape[1])).sum().backward()
    out["fa"] = gather_frames(y.detach(), mesh).numpy()
    out["fa_dq"] = gather_frames(qt.grad, mesh).numpy()
    out["fa_dk"], out["fa_dv"] = kt.grad.numpy(), vt.grad.numpy()
    # GroupNorm: a frame-pooled (N, F·rows, C) slab split over frames and a
    # per-frame (B·F, rows, C) slab
    gn = make_sharded_group_norm_fn(mesh)
    x5t = frames_slice(torch.from_numpy(x5), mesh).clone().requires_grad_(True)
    wt, bt = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    y5 = gn(x5t.reshape(1, -1, x5.shape[-1]), wt, bt, num_groups=4, eps=1e-5, act="silu",
            pooled=True).reshape(x5t.shape)
    (y5 * y5).sum().backward()
    out["gn_pooled"] = gather_frames(y5.detach(), mesh).numpy()
    out["gn_dx"] = gather_frames(x5t.grad, mesh).numpy()
    out["gn_dw"], out["gn_db"] = wt.grad.numpy(), bt.grad.numpy()
    # the same slab through the staged kernel's autograd Function (its two
    # launches' plain versions here on the CPU, the all-reduce between
    # them, the backward recomputed through the plain pooled norm)
    from videop2p_tpu_torch.parallel.mesh import AXIS_FRAMES, _PooledGroupNorm

    x5s = frames_slice(torch.from_numpy(x5), mesh).clone().requires_grad_(True)
    ws, bs = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    ys = _PooledGroupNorm.apply(x5s.reshape(1, -1, x5.shape[-1]), ws, bs, 4, 1e-5, "silu",
                                mesh.group(AXIS_FRAMES)).reshape(x5s.shape)
    (ys * ys).sum().backward()
    out["gn_staged"] = gather_frames(ys.detach(), mesh).numpy()
    out["gn_staged_dx"] = gather_frames(x5s.grad, mesh).numpy()
    out["gn_staged_dw"], out["gn_staged_db"] = ws.grad.numpy(), bs.grad.numpy()
    x4t = frames_slice(torch.from_numpy(x4), mesh, dim=0)
    out["gn_frame"] = gather_frames(
        gn(x4t, torch.from_numpy(w), torch.from_numpy(b), num_groups=4, eps=1e-6, act="none",
           pooled=False), mesh, dim=0).numpy()
    return out


def test_sharded_wrappers_match_unsharded():
    """Frame attention over split frames (the K/V of frame 0 broadcast
    from frames-rank 0, the gradients of the other ranks' K/V summed back
    onto it) and GroupNorm on both kinds of site equal the whole-clip
    computation, forward and backward."""
    from videop2p_tpu_torch.ops.attention import dense_frame_attention
    from videop2p_tpu_torch.ops.groupnorm import group_norm_reference

    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, F, 2, 16, 4)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 16, 4)).astype(np.float32) for _ in range(2))
    x5 = rng.normal(size=(1, F, 4, 4, 8)).astype(np.float32) * 2 + 0.5
    x4 = rng.normal(size=(F, 16, 8)).astype(np.float32)
    w, b = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    r0, r1 = run_ranks(_wrappers_worker, 2, q, k, v, x5, x4, w, b)

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    y = dense_frame_attention(qt, kt, vt)
    (y * torch.linspace(-1, 1, y.numel()).view(y.shape).narrow(1, 0, y.shape[1])).sum().backward()
    # the weights of each rank's half of the frames
    per = F // 2
    grads = []
    for s in range(2):
        qs = torch.from_numpy(q[:, s * per:(s + 1) * per]).requires_grad_(True)
        ks, vs = (torch.from_numpy(a).requires_grad_(True) for a in (k, v))
        ys = dense_frame_attention(qs, ks, vs)
        (ys * torch.linspace(-1, 1, ys.numel()).view(ys.shape).narrow(1, 0, ys.shape[1])).sum().backward()
        grads.append((qs.grad, ks.grad, vs.grad))
    for r in (r0, r1):
        np.testing.assert_allclose(r["fa"], y.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(r0["fa_dq"], torch.cat([g[0] for g in grads], 1).numpy(), atol=1e-6)
    np.testing.assert_allclose(r0["fa_dk"], (grads[0][1] + grads[1][1]).numpy(), atol=1e-5)
    np.testing.assert_allclose(r0["fa_dv"], (grads[0][2] + grads[1][2]).numpy(), atol=1e-5)
    assert not r1["fa_dk"].any() and not r1["fa_dv"].any()

    x5t = torch.from_numpy(x5).requires_grad_(True)
    wt, bt = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    y5 = group_norm_reference(x5t.reshape(1, -1, 8), wt, bt, num_groups=4, eps=1e-5,
                              act="silu").reshape(x5.shape)
    (y5 * y5).sum().backward()
    for r in (r0, r1):
        np.testing.assert_allclose(r["gn_pooled"], y5.detach().numpy(), atol=2e-6)
        np.testing.assert_allclose(r["gn_dx"], x5t.grad.numpy(), atol=2e-5)
        # each rank's share of the scale/bias gradient sums to the whole
    np.testing.assert_allclose(r0["gn_dw"] + r1["gn_dw"], wt.grad.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(r0["gn_db"] + r1["gn_db"], bt.grad.numpy(), rtol=1e-5, atol=1e-4)
    for r in (r0, r1):
        np.testing.assert_allclose(r["gn_staged"], y5.detach().numpy(), atol=2e-6)
        np.testing.assert_allclose(r["gn_staged_dx"], x5t.grad.numpy(), atol=2e-5)
    np.testing.assert_allclose(r0["gn_staged_dw"] + r1["gn_staged_dw"], wt.grad.numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(r0["gn_staged_db"] + r1["gn_staged_db"], bt.grad.numpy(),
                               rtol=1e-5, atol=1e-4)
    want4 = group_norm_reference(torch.from_numpy(x4), torch.from_numpy(w), torch.from_numpy(b),
                                 num_groups=4, eps=1e-6, act="none")
    np.testing.assert_allclose(r0["gn_frame"], want4.numpy(), atol=1e-6)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_staged_group_norm_matches_jax_reference(shards):
    """The GroupNorm kernel's two staged launches (their plain versions on
    the CPU): the statistics of each of ``shards`` row blocks, summed, then
    the apply of each block, equal JAX's ``group_norm_reference`` on the
    whole slab (1e-5); the plans of the two launches are valid (the apply
    keeps no slab)."""
    import jax.numpy as jnp

    from videop2p_tpu.ops.groupnorm import group_norm_reference as jax_reference
    from videop2p_tpu_torch.ops.groupnorm import group_norm_apply, group_norm_stats, plan

    rng = np.random.default_rng(shards)
    x = (rng.normal(size=(2, 8 * 16, 64)) * 2 + 0.5).astype(np.float32)
    w, b = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    blocks = torch.from_numpy(x).chunk(shards, dim=1)
    sums = sum(group_norm_stats(blk, num_groups=32) for blk in blocks)
    assert sums.shape == (2, 32, 2) and sums.dtype == torch.float32
    got = torch.cat([group_norm_apply(blk, sums, torch.from_numpy(w), torch.from_numpy(b),
                                      num_groups=32, eps=1e-5, act="silu", shards=shards)
                     for blk in blocks], dim=1)
    want = np.asarray(jax_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    num_groups=32, eps=1e-5, act="silu"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError, match="sums must be float32"):
        group_norm_apply(blocks[0], sums[:1], torch.from_numpy(w), torch.from_numpy(b),
                         num_groups=32)
    # the resnet slab of a rank holding 8 / shards frames at 64², C 320
    p = plan(2, 8 // shards * 4096, 320, torch.float32, 132)
    assert p.smem_rows > 0 and p.smem_bytes <= 232_448


def test_param_shardings_match_jax_specs():
    """Every port parameter's tensor split is JAX's ``param_shardings`` spec
    of its flax path (``convert.py:unet_jax_paths``): column-parallel
    ``P(None, "tensor")`` is torch dim 0, row-parallel ``P("tensor",
    None)`` dim 1, everything else replicated; default all replicated."""
    import jax

    from videop2p_tpu.parallel import make_mesh as jax_make_mesh
    from videop2p_tpu.parallel import param_shardings as jax_param_shardings
    from tests.test_torch_parity import tiny_unet_pair

    from videop2p_tpu_torch.models.convert import unet_jax_paths
    from videop2p_tpu_torch.parallel import make_mesh, param_shardings

    _, variables, pmodel = tiny_unet_pair(seed=0, frames=2)
    jmesh = jax_make_mesh((1, 1, 2), devices=jax.devices()[:2])
    specs = jax_param_shardings(jmesh, variables["params"], tensor_parallel=True)
    flat = {tuple(str(getattr(k, "key", k)) for k in path): leaf.spec
            for path, leaf in jax.tree_util.tree_flatten_with_path(specs)[0]}
    mesh = make_mesh((1, 1, 1))
    port = param_shardings(mesh, pmodel, tensor_parallel=True)
    paths = unet_jax_paths(pmodel)
    assert set(port) == set(paths) and len(flat) == len(port)
    split = 0
    for name, dim in port.items():
        spec = tuple(flat[paths[name]])
        want = None
        if spec and spec[0] == "tensor":
            want = 1
        elif len(spec) > 1 and spec[1] == "tensor":
            want = 0
        assert dim == want, (name, spec, dim)
        split += dim is not None
    # every transformer block: q, k, v, out at its three sites and the FF's two
    from videop2p_tpu_torch.models.attention import BasicTransformerBlock

    blocks = sum(isinstance(m, BasicTransformerBlock) for m in pmodel.modules())
    assert blocks and split == 14 * blocks
    assert all(d is None for d in param_shardings(mesh, pmodel).values())


def test_geglu_matched_split():
    """``proj_geglu`` concatenates [h | gate]: each tensor rank takes the
    same slice of both halves, so its local ``chunk(2)`` pairs h and gate
    columns of the same features, and the row-parallel ``proj_out`` slices
    over those features; the partial outputs sum to the whole FF."""
    from videop2p_tpu_torch.models.attention import FeedForward
    from videop2p_tpu_torch.parallel.mesh import _shard_tensor

    torch.manual_seed(0)
    ff = FeedForward(8).eval()
    x = torch.randn(2, 5, 8)
    whole = ff(x)
    sd = ff.state_dict()
    total = torch.zeros_like(whole)
    for index in range(2):
        part = FeedForward(8).eval()
        local = {}
        for name, t in sd.items():
            dim = 0 if name.startswith("net.0.proj") else 1 if name == "net.2.weight" else None
            local[name] = t if dim is None else _shard_tensor(name, t, dim, 2, index)
        h, gate = local["net.0.proj.weight"].chunk(2, 0)
        wh, wg = sd["net.0.proj.weight"].chunk(2, 0)
        assert torch.equal(h, wh[index * 16:(index + 1) * 16])
        assert torch.equal(gate, wg[index * 16:(index + 1) * 16])
        part.net[0].proj.weight.data = local["net.0.proj.weight"]
        part.net[0].proj.bias.data = local["net.0.proj.bias"]
        part.net[2].weight.data = local["net.2.weight"]
        part.net[2].bias.data = torch.zeros(8)
        total = total + part(x)
    np.testing.assert_allclose((total + sd["net.2.bias"]).detach().numpy(),
                               whole.detach().numpy(), atol=1e-6)


# ------------------------------------------------------ the whole model --


def _model_worker(rank, world, sd, inp, specs, collective_pairs):
    from videop2p_tpu_torch.parallel.mesh import (
        CommRecorder,
        frames_slice,
        gather_frames,
        set_active_mesh,
    )

    out = {}
    for spec in specs:
        unet, mesh = _setup(sd, spec)
        x = frames_slice(torch.from_numpy(inp["x"]), mesh)
        with torch.no_grad():
            y = unet(x, 5, torch.from_numpy(inp["text"]))
        out[spec] = gather_frames(y, mesh).numpy()
        set_active_mesh(None)
    for a, b in collective_pairs:  # "gspmd" vs "psum_scatter" on (1,1,2)
        res = {}
        for mode in (a, b):
            from videop2p_tpu_torch.cli.common import setup_mesh

            bundle = SimpleNamespace(unet=_port_unet(sd))
            mesh = setup_mesh(bundle, "1,1,2", F, tp_collectives=mode, device=torch.device("cpu"))
            with torch.no_grad(), CommRecorder() as rec:
                y = bundle.unet(torch.from_numpy(inp["x"]), 5, torch.from_numpy(inp["text"]))
            res[mode] = (y.numpy(), dict(rec.per_kind))
            set_active_mesh(None)
        out["collectives"] = res
    return out


def _jax_forward(variables, jmodel, inp, mesh_shape=None):
    import jax
    import jax.numpy as jnp

    from tests.test_torch_parity import jit_apply

    if mesh_shape is None:
        return np.asarray(jit_apply(jmodel, variables, inp["x"], jnp.asarray(5), inp["text"]))
    from videop2p_tpu.parallel import latent_sharding, make_mesh, param_shardings

    n = int(np.prod(mesh_shape))
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    params = jax.device_put(variables, param_shardings(mesh, variables, tensor_parallel=True))
    x = jax.device_put(jnp.asarray(inp["x"]), latent_sharding(mesh))
    return np.asarray(jit_apply(jmodel, params, x, jnp.asarray(5), inp["text"]))


@pytest.fixture(scope="module")
def model_runs():
    """One run of 2 ranks ((1,2,1), (1,1,2) forwards, the two row-parallel
    reductions) and one of 4 ranks ((1,2,2)) over the same weights."""
    from tests.test_torch_parity import tiny_unet_pair

    jmodel, variables, pmodel = tiny_unet_pair(seed=3, frames=F)
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    inp = _inputs()
    two = run_ranks(_model_worker, 2, sd, inp, ["1,2,1", "1,1,2"],
                    [("gspmd", "psum_scatter")])
    four = run_ranks(_model_worker, 4, sd, inp, ["1,2,2"], [])
    with torch.no_grad():
        plain = pmodel(torch.from_numpy(inp["x"]), 5, torch.from_numpy(inp["text"])).numpy()
    return SimpleNamespace(jmodel=jmodel, variables=variables, pmodel=pmodel, sd=sd, inp=inp,
                           two=two, four=four, plain=plain)


@pytest.mark.parametrize("spec", ["1,2,1", "1,1,2", "1,2,2"])
def test_unet_forward_on_mesh_matches_jax(model_runs, spec):
    """The tiny UNet's forward on a mesh equals JAX's unsharded forward
    within 2e-4 on every rank, and the unsharded port's within 2e-5; the
    (1,2,2) run also equals JAX's forward on its own (1,2,2) mesh."""
    m = model_runs
    runs = m.four if spec == "1,2,2" else m.two
    want = _jax_forward(m.variables, m.jmodel, m.inp)
    for r in runs:
        np.testing.assert_allclose(r[spec], want, atol=2e-4)
        np.testing.assert_allclose(r[spec], m.plain, atol=2e-5)
    if spec == "1,2,2":
        np.testing.assert_allclose(runs[0][spec], _jax_forward(
            m.variables, m.jmodel, m.inp, (1, 2, 2)), atol=2e-4)


def test_gspmd_vs_psum_scatter(model_runs):
    """The two row-parallel reductions compute one forward; the explicit
    reduce-scatter moves 1/tp of the bytes the spatial sites' all-reduce
    does (the temporal sites all-reduce under both)."""
    for r in model_runs.two:
        (ya, ka), (yb, kb) = r["collectives"]["gspmd"], r["collectives"]["psum_scatter"]
        np.testing.assert_allclose(ya, yb, atol=1e-6)
        np.testing.assert_allclose(ya, model_runs.plain, atol=2e-5)
        assert "reduce-scatter" not in ka and kb["reduce-scatter"]["count"] > 0
        spatial = ka["all-reduce"]["bytes"] - kb["all-reduce"]["bytes"]
        assert spatial > 0 and kb["reduce-scatter"]["bytes"] * 2 == spatial
        assert kb["reduce-scatter"]["count"] == ka["all-reduce"]["count"] - kb["all-reduce"]["count"]


# ------------------------------------------------------------ pipelines --


def _pipeline_worker(rank, world, sd, inp, nt_epsilon):
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import cached_fast_edit, make_unet_fn
    from videop2p_tpu_torch.pipelines.cached import capture_windows
    from videop2p_tpu_torch.pipelines.inversion import ddim_inversion, null_text_optimization
    from videop2p_tpu_torch.parallel.mesh import frames_slice, gather_frames, set_active_mesh
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    unet, mesh = _setup(sd, "1,2,1")
    fn, sched = make_unet_fn(unet), DDIMScheduler.create_sd()
    ctx = make_controller(PROMPTS, WordTokenizer(), STEPS, **CTRL)
    cross_len, self_window = capture_windows(ctx, STEPS)
    x = frames_slice(torch.from_numpy(inp["x"]), mesh)
    cond, uncond = torch.from_numpy(inp["cond"]), torch.from_numpy(inp["uncond"])
    traj, edited = cached_fast_edit(fn, sched, x, cond[:1], cond, uncond, ctx,
                                    num_inference_steps=STEPS, cross_len=cross_len,
                                    self_window=self_window)
    out = {"src_err": float((edited[0] - x[0]).abs().max()),
           "edited": gather_frames(edited, mesh).numpy(),
           "traj": gather_frames(traj, mesh, dim=2).numpy()}
    with torch.no_grad():
        traj = ddim_inversion(fn, sched, x, cond[:1], num_inference_steps=STEPS)
    emb, losses, inner = null_text_optimization(
        fn, sched, traj, cond[:1], uncond[None], num_inference_steps=STEPS,
        num_inner_steps=4, epsilon=nt_epsilon, return_losses=True, return_inner_steps=True)
    out.update(nt_emb=emb.numpy(), nt_losses=losses.numpy(), nt_inner=np.asarray(inner))
    set_active_mesh(None)
    return out


@pytest.fixture(scope="module")
def pipeline_runs():
    from tests.test_torch_parity import tiny_unet_pair

    jmodel, variables, pmodel = tiny_unet_pair(seed=4, frames=F)
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    inp = _inputs(1)
    eps = 4.2  # outer step 0 stops after 2 inner steps, the others run all 4
    ranks = run_ranks(_pipeline_worker, 2, sd, inp, eps)
    return SimpleNamespace(jmodel=jmodel, variables=variables, pmodel=pmodel, inp=inp,
                           ranks=ranks, eps=eps)


def _jax_cached_edit(jmodel, variables, inp, mesh_shape=None):
    import jax
    import jax.numpy as jnp

    from videop2p_tpu.control import make_controller
    from videop2p_tpu.core import DDIMScheduler
    from videop2p_tpu.pipelines import make_unet_fn
    from videop2p_tpu.pipelines.cached import capture_windows
    from videop2p_tpu.pipelines.fast import cached_fast_edit
    from videop2p_tpu.utils.tokenizers import WordTokenizer

    ctx = make_controller(PROMPTS, WordTokenizer(), STEPS, **CTRL)
    c, sw = capture_windows(ctx, STEPS)
    params, x = variables, jnp.asarray(inp["x"])
    if mesh_shape is not None:
        from videop2p_tpu.parallel import latent_sharding, make_mesh, param_shardings

        mesh = make_mesh(mesh_shape, devices=jax.devices()[:int(np.prod(mesh_shape))])
        params = jax.device_put(params, param_shardings(mesh, params, tensor_parallel=True))
        x = jax.device_put(x, latent_sharding(mesh))
    fn = make_unet_fn(jmodel)
    with jax.default_matmul_precision("highest"):
        _, out = jax.jit(lambda p, x: cached_fast_edit(
            fn, p, DDIMScheduler.create_sd(), x, inp["cond"][:1], inp["cond"], inp["uncond"],
            ctx, num_inference_steps=STEPS, guidance_scale=7.5, cross_len=c,
            self_window=sw))(params, x)
    return np.asarray(out)


def test_cached_fast_edit_on_mesh_matches_jax(pipeline_runs):
    """The cached fast edit with frames over 2 ranks equals JAX's unsharded
    edit and JAX's (1,4,2)-sharded one within 2e-3 (the captured maps are
    stored in bf16 on both sides, which rounds summation-order noise to
    different ulps), and stream 0 replays x_0 bit for bit on every rank."""
    s = pipeline_runs
    r0, r1 = s.ranks
    np.testing.assert_array_equal(r0["edited"], r1["edited"])
    assert r0["src_err"] == 0.0 and r1["src_err"] == 0.0
    np.testing.assert_array_equal(r0["edited"][0], s.inp["x"][0])
    unsharded = _jax_cached_edit(s.jmodel, s.variables, s.inp)
    sharded = _jax_cached_edit(s.jmodel, s.variables, s.inp, (1, 4, 2))
    np.testing.assert_allclose(r0["edited"], unsharded, atol=2e-3)
    np.testing.assert_allclose(r0["edited"], sharded, atol=2e-3)
    assert np.abs(r0["edited"][1] - r0["edited"][0]).max() > 1e-3


def test_null_text_on_mesh_stops_together(pipeline_runs):
    """Null-text with frames over 2 ranks: the loss is the global mean, so
    every rank stops at the same inner step of every outer step (some
    early, some not at this ε), and the embeddings equal the unsharded
    port's."""
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.pipelines.inversion import ddim_inversion, null_text_optimization

    s = pipeline_runs
    r0, r1 = s.ranks
    np.testing.assert_array_equal(r0["nt_inner"], r1["nt_inner"])
    np.testing.assert_array_equal(r0["nt_losses"], r1["nt_losses"])
    np.testing.assert_array_equal(r0["nt_emb"], r1["nt_emb"])
    fn, sched = make_unet_fn(s.pmodel), DDIMScheduler.create_sd()
    cond, uncond = torch.from_numpy(s.inp["cond"]), torch.from_numpy(s.inp["uncond"])
    with torch.no_grad():
        traj = ddim_inversion(fn, sched, torch.from_numpy(s.inp["x"]), cond[:1],
                              num_inference_steps=STEPS)
    emb, losses, inner = null_text_optimization(
        fn, sched, traj, cond[:1], uncond[None], num_inference_steps=STEPS, num_inner_steps=4,
        epsilon=s.eps, return_losses=True, return_inner_steps=True)
    np.testing.assert_array_equal(r0["nt_inner"], np.asarray(inner))
    assert 0 < min(inner) and min(inner) < 4 and max(inner) == 4, inner
    np.testing.assert_allclose(r0["nt_losses"], losses.numpy(), rtol=1e-4)
    # Adam divides each gradient element by its own running norm, so the
    # summation-order noise of a small element moves its update: 6.6e-5
    # measured (the JAX parity test of null-text bounds it by 2e-2)
    np.testing.assert_allclose(r0["nt_emb"], emb.numpy(), atol=1e-3)


# --------------------------------------------------------------- Stage 1 --


def _train_worker(rank, world, sd, inp, specs, steps):
    from videop2p_tpu_torch.core import DDPMScheduler
    from videop2p_tpu_torch.obs.comm import tree_replica_divergence
    from videop2p_tpu_torch.parallel.mesh import (
        AXIS_FRAMES,
        AXIS_TENSOR,
        frames_slice,
        gather_tensor,
        set_active_mesh,
    )
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import TrainState, TuneConfig, make_optimizer, train_steps

    out = {}
    for spec in specs:
        unet, mesh = _setup(sd, spec)
        unet.train()
        tx = make_optimizer(TuneConfig(learning_rate=1e-3, max_grad_norm=0.05))
        state = TrainState.create(unet, tx)
        x = frames_slice(torch.from_numpy(inp["x"]), mesh)
        _, losses = train_steps(make_unet_fn(unet), tx, state, DDPMScheduler.create_sd(), x,
                                torch.from_numpy(inp["text"]), 11, num_steps=steps)
        dims = getattr(unet, "tp_shard_dims", {})
        params = state.params
        whole = {n: gather_tensor(n, p.detach(), dims.get(n), mesh).numpy()
                 for n, p in state.trainable.items()}
        div = max(float(tree_replica_divergence(list(params.values()), mesh, axes=(AXIS_FRAMES,))),
                  float(tree_replica_divergence(
                      [p for n, p in params.items() if n not in dims], mesh, axes=(AXIS_TENSOR,))))
        out[spec] = dict(params=whole, losses=losses.numpy(), divergence=div)
        set_active_mesh(None)
    return out


def test_stage1_step_on_mesh_matches_unsharded():
    """Two Stage-1 steps (noise and timesteps drawn whole on every rank,
    the loss the global mean, the replicated gradients summed over frames,
    the clip norm — here active — over the global gradient with each
    tensor-split parameter counted once) on (1,2,1) and (1,1,2) equal the
    unsharded steps, and the replicas stay identical: divergence 0.0."""
    from videop2p_tpu_torch.core import DDPMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import TrainState, TuneConfig, make_optimizer, train_steps

    from tests.test_torch_parity import tiny_unet_pair

    _, _, pmodel = tiny_unet_pair(seed=5, frames=F)
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    inp = _inputs(2)
    ranks = run_ranks(_train_worker, 2, sd, inp, ["1,2,1", "1,1,2"], 2)
    unet = _port_unet(sd).train()
    tx = make_optimizer(TuneConfig(learning_rate=1e-3, max_grad_norm=0.05))
    state = TrainState.create(unet, tx)
    _, losses = train_steps(make_unet_fn(unet), tx, state, DDPMScheduler.create_sd(),
                            torch.from_numpy(inp["x"]), torch.from_numpy(inp["text"]), 11,
                            num_steps=2)
    moved = False
    for spec in ("1,2,1", "1,1,2"):
        for r in ranks:
            got = r[spec]
            assert got["divergence"] == 0.0
            np.testing.assert_allclose(got["losses"], losses.numpy(), rtol=1e-5)
            for name, p in state.trainable.items():
                np.testing.assert_allclose(got["params"][name], p.detach().numpy(), atol=1e-6,
                                           err_msg=f"{spec} {name}")
                moved |= bool(np.abs(got["params"][name] - sd[name]).max() > 1e-5)
    assert moved


# ------------------------------------------------------------ ProgramSet --


def _programset_worker(rank, world, frames, mesh):
    from videop2p_tpu_torch.parallel.mesh import set_active_mesh
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    ps = ProgramSet(ProgramSpec(tiny=True, width=16, video_len=F, steps=2, mesh=mesh),
                    device="cpu")
    latents = ps.encode(ps.frames_to_video(frames))
    ctx = ps.controller(PROMPTS, blend_word=("rabbit", "rabbit"),
                        eq_params={"words": ["origami"], "values": [2]})
    _, cached = ps.invert_capture(latents, ps.encode_prompts(PROMPTS[:1]), ctx)
    temporal = {k: tuple(v.shape) for k, v in (cached.temporal_maps or {}).items()}
    videos, src_err = ps.edit_decode(cached, ps.encode_prompts(PROMPTS),
                                     ps.encode_prompts([""])[0], ctx, latents)
    set_active_mesh(None)
    from videop2p_tpu_torch.models.attention import FrameAttention

    # the frame attention each site runs: the seam's where the mesh set one
    impls = {(m.frame_attention_fn or m.attention_fn).impl
             for m in ps.bundle.unet.modules() if isinstance(m, FrameAttention)}
    return dict(videos=videos.numpy(), src_err=float(src_err), latents=tuple(latents.shape),
                temporal=temporal, mesh=None if ps.mesh is None else ps.mesh.spec(),
                frame_attention=impls)


def test_programset_on_mesh_matches_one_process():
    """A ProgramSet of a (1,2,1) spec on 2 ranks (the model-parallel
    branch: "chunked" UNet, the sharded wrappers resolving "auto"): each
    rank encodes its frames, captures its query rows of the temporal maps
    — (B·N, H, F/2, F) where GSPMD would shard the spatial positions — and
    the gathered decode equals the one-process set's videos; stream 0
    replays its source bit for bit on each rank (src_err 0.0)."""
    frames = np.random.default_rng(5).integers(0, 256, (F, 16, 16, 3), dtype=np.uint8)
    r0, r1 = run_ranks(_programset_worker, 2, frames, "1,2,1")
    one = _programset_worker(0, 1, frames, None)
    assert r0["mesh"] == "1,2,1" and one["mesh"] is None
    assert r0["latents"][1] == F // 2 and one["latents"][1] == F
    for path, shape in one["temporal"].items():
        assert r0["temporal"][path] == shape[:-2] + (F // 2, F), path
    for r in (r0, r1):
        assert r["src_err"] == 0.0
        np.testing.assert_allclose(r["videos"], one["videos"], atol=2e-3)
    np.testing.assert_array_equal(r0["videos"], r1["videos"])
    assert r0["frame_attention"] == one["frame_attention"] == {"auto"}


def test_programset_on_tensor_mesh_matches_one_process():
    """A ProgramSet of a (1,1,2) spec on 2 ranks (heads split, no frame
    seam): every frame-attention site runs "auto" on its local heads (the
    fused kernel on the card, as on one GPU), each rank keeps the whole
    clip and captures its heads of the temporal maps, and the decode equals the one-process set's videos; stream 0
    replays its source bit for bit."""
    frames = np.random.default_rng(6).integers(0, 256, (F, 16, 16, 3), dtype=np.uint8)
    r0, r1 = run_ranks(_programset_worker, 2, frames, "1,1,2")
    one = _programset_worker(0, 1, frames, None)
    assert r0["mesh"] == "1,1,2" and r0["latents"] == one["latents"]
    assert r0["frame_attention"] == r1["frame_attention"] == {"auto"}
    # the capture holds this rank's heads of every temporal map
    for path, shape in one["temporal"].items():
        assert r0["temporal"][path] == shape[:2] + (shape[2] // 2,) + shape[3:], path
    for r in (r0, r1):
        assert r["src_err"] == 0.0
        np.testing.assert_allclose(r["videos"], one["videos"], atol=2e-3)
