"""The port's multi-device path (``aid_tpu_torch.parallel``) against the JAX
package's mesh code, on the CPU.

The rules are held to JAX on the same shapes in this process: the dp mesh
size (``make_mesh``'s clamp), the FSDP placement (``fsdp_shardings``) and
the tp placement (``param_shardings``). The port's process groups run in
three spawned groups of ranks over gloo (tests/torch_dist_worker.py, which
imports no JAX); their results are held here against JAX computed in this
process (the 8-device CPU mesh of tests/conftest.py) or against the
one-rank port:

  * train (2 ranks): 3 DDP steps (eagerly and through the dp step
    program) and 3 FSDP steps of the tiny trainer
    (tests/test_torch_trainer.py's configuration) on JAX's global batch and
    draws, split by rank; the rule that says which steps run as programs
    and the capture guard; the FSDP state's shards; an FSDP checkpoint saved
    at world 2 and resumed at world 1, and one saved at world 1 and resumed
    at world 2;
  * attention (2 ranks): ring attention with a bias (forward and the q, k,
    v and bias gradients), the U-Net with cp attention (forward and input
    gradient), the tp=2 U-Net (forward and guided score), a request
    served by ``shard`` over dp=2 through each rank's programs, and the
    capture guard of every collective;
  * serve_dp_tp (4 ranks): the request served over a dp=2 x tp=2 mesh
    (eagerly), the refusals, ``autotune_max_batch`` over dp=4.

Everything is f32; each tolerance is stated where it is used.
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aid_tpu import setup as asetup
from aid_tpu.diffusion import edm as jedm
from aid_tpu.parallel import mesh as jmesh
from aid_tpu.parallel import ring_attention as jring
from aid_tpu.parallel import tp as jtp
from aid_tpu.sampling import degradations as jdegr
from aid_tpu.sampling import heun as jheun
from aid_tpu.utils.config import compose as jcompose
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.models import unet_cqt as tunet
from aid_tpu_torch.parallel import mesh as pmesh
from aid_tpu_torch.parallel import ring_attention as pring
from aid_tpu_torch.parallel import tp as ptp
from aid_tpu_torch.serving import InpaintingService
from aid_tpu_torch.utils import checkpoint as ckpt
from aid_tpu_torch.utils.config import compose
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests import test_torch_unet as tu
from tests.test_torch_trainer import (TINY, _batch, _jax, _jax_draws, _jax_state, _port,
                                      _port_state, _rel_l2)
from tests.torch_dist_worker import Group
from tests.torch_threads import one_torch_thread  # noqa: F401

# ---------------------------------------------------------------- the rules


@pytest.mark.parametrize("n_dp", [-1, 1, 3, 5, 8, 16])
@pytest.mark.parametrize("batch", [None, 1, 4, 6, 12])
def test_mesh_size_clamps_like_jax(n_dp, batch):
    """The dp mesh over 8 ranks has as many ranks as JAX's over 8 devices."""
    assert pmesh.mesh_size(n_dp, 8, batch) == jmesh.make_mesh(n_dp, batch=batch).devices.size


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_local_batch_size_matches_jax(n):
    """A rank is one device: its rows are JAX's host share over the host's
    devices (here one process holds all n)."""
    mesh = jmesh.make_mesh(n)
    assert pmesh.local_batch_size(16, n) == jmesh.local_batch_size(16, mesh) // n
    with pytest.raises(ValueError):
        pmesh.local_batch_size(6, 4)


@pytest.mark.parametrize("n_dp,world,batch", [(3, 4, 8), (-1, 4, 6), (2, 8, 16)])
def test_a_mesh_that_leaves_ranks_out_raises(n_dp, world, batch):
    """JAX silently runs on the devices of the clamp; ranks outside it would
    sit idle (and deadlock the first collective), so the port refuses."""
    with pytest.raises(ValueError, match="without work"):
        pmesh.dp_ranks(n_dp, world, batch)
    assert pmesh.dp_ranks(-1, world, 8 * world) == world


@pytest.mark.parametrize("cards,ranks,want", [(1, 1, "nccl"), (1, 2, "gloo"), (8, 8, "nccl"),
                                              (4, 8, "gloo")])
def test_backend_follows_the_launch(monkeypatch, cards, ranks, want):
    """NCCL when every rank on the host has its own card, gloo when ranks
    share one (NCCL refuses that) and when the caller names the CPU; no
    card and no explicit device raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(ranks))
    assert pmesh.choose_backend()[0] == want
    assert pmesh.choose_backend("cpu")[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.choose_backend()


def test_no_group_without_a_launcher_or_a_request(monkeypatch):
    for k in ("WORLD_SIZE", "AID_TPU_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed(False, device="cpu") is False
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def tiny_params():
    """The tiny trainer's JAX parameters and the port's network of them."""
    ja = jcompose(overrides=TINY + ["model_dir=unused"])
    bundle = asetup.setup_network(ja)
    bundle.init(jax.random.PRNGKey(0), 1, 2048)
    params = jax.device_get(bundle.params)
    net = tsetup.setup_network(compose(overrides=TINY), device="cpu",
                               state_dict=state_dict_from_flax(params), trainable=True)
    return params, net


def _jax_rule_by_name(params, value):
    """{port parameter name: value(JAX leaf, its sharding spec)} through the
    flax -> state-dict converter (each leaf filled with its value)."""
    tree = jax.tree_util.tree_map(lambda leaf, v: np.full(np.shape(leaf), v, np.float32),
                                  params, value)
    return {n: float(t.reshape(-1)[0]) if t.numel() else 0.0
            for n, t in state_dict_from_flax(tree).items()}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_placement_follows_jax(tiny_params, n):
    """Sharded or replicated as JAX's fsdp_shardings (min_size 256), sharded
    on a dim of the same size (the layouts order dims differently)."""
    params, net = tiny_params
    mesh = Mesh(np.array(jax.devices()[:n]), (jmesh.DATA_AXIS,))
    sh = jmesh.fsdp_shardings(params, mesh, min_size=256)
    spec_dim = jax.tree_util.tree_map(
        lambda leaf, s: next((np.shape(leaf)[i] for i, a in enumerate(s.spec)
                              if a == jmesh.DATA_AXIS), 0), params, sh)
    want = _jax_rule_by_name(params, spec_dim)
    got = {}
    for name, p in net.named_parameters():
        d = pmesh.fsdp_shard_dim(tuple(p.shape), n, 256)
        got[name] = 0.0 if d is None else float(p.shape[d])
    assert got == want
    assert sum(v > 0 for v in got.values()) >= 10


@pytest.mark.parametrize("n_tp", [2, 4])
def test_tp_placement_follows_jax(tiny_params, n_tp):
    """Split on the output channels exactly where JAX's param_shardings
    splits the kernel's last dim."""
    params, net = tiny_params
    sh = jtp.param_shardings(params, jtp.make_tp_mesh(n_tp, n_dp=1))
    split = jax.tree_util.tree_map(lambda s: float(len(s.spec) > 0 and s.spec[-1] == "tp"), sh)
    want = _jax_rule_by_name(params, split)
    got = {n: float(v == "shard0") for n, v in ptp.param_placements(net, n_tp).items()}
    assert got == want
    assert sum(got.values()) >= 10


def test_ring_attention_without_a_group_is_dense():
    """Without a process group ring attention is the dense softmax
    attention, and no cp mesh is installed."""
    assert not torch.distributed.is_initialized()
    q, k, v = (torch.randn(1, 2, 8, 4, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    ref = torch.softmax(q @ k.transpose(-1, -2) * 0.5, -1) @ v
    torch.testing.assert_close(pring.ring_attention(q, k, v), ref, rtol=1e-6, atol=1e-6)
    assert pring.get_cp_mesh() is None


# ----------------------------------------------------------------- training

FSDP = ["exp.mesh.dp=2", "exp.mesh.fsdp=True", "exp.mesh.fsdp_min_size=256"]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """JAX's 3 steps; the port's world-1 run (with its step-2 checkpoint);
    the 2-rank group's runs."""
    tmp = str(tmp_path_factory.mktemp("train"))
    jtr = _jax(tmp, TINY)
    sd = state_dict_from_flax(jax.device_get(jtr.state.params))
    rng = np.random.default_rng(0)
    steps = []
    key = jtr.key
    for _ in range(3):   # the draws of JAX's next 3 steps (a step splits the key)
        audio, fs = _batch(rng)
        steps.append((audio[None], fs[None], _jax_draws(SimpleNamespace(key=key, p=jtr.p), 1)))
        key = jax.random.split(key)[0]
    w1 = _port(tmp, TINY, sd, sub="world1")
    for audio, fs, draws in steps[:2]:
        w1.train_step(audio[0], fs[0], draws)
    w1_ckpt = w1.save_checkpoint()
    w1.train_step(steps[2][0][0], steps[2][1][0], steps[2][2])
    # 2 micro-batches of 2 rows a step (one row a rank in each)
    acc_steps = []
    for _ in range(3):
        audio, fs = _batch(rng)
        acc_steps.append((audio.reshape(2, 2, -1), fs.reshape(2, 2),
                          [_micro_draws(rng, 2) for _ in range(2)]))
    acc = _port(tmp, TINY + ["exp.num_accumulation_rounds=2"], sd, sub="accumulate")
    acc_metrics = [acc.train_step(a.reshape(4, -1), f.reshape(-1), d) for a, f, d in acc_steps]
    group = Group("train", 2, os.path.join(tmp, "group"),
                  {"overrides": TINY, "state_dict": sd, "steps": steps, "fsdp": FSDP,
                   "world1_checkpoint": w1_ckpt, "accumulate_steps": acc_steps})
    jax_metrics = [jtr.train_step(audio[0], fs[0]) for audio, fs, _ in steps]
    return dict(jax_metrics=jax_metrics, jax_state=_jax_state(jtr), p0=sd, steps=steps,
                world1=_port_state(w1), names=w1.names, tmp=tmp, sd=sd,
                accumulate=(acc_metrics, _port_state(acc)), ranks=group.results())


def _micro_draws(rng, n):
    """A micro-batch of n rows of draws, as the trainer would draw them."""
    sigma = np.exp(rng.uniform(-6, 1, n)).astype(np.float32)
    return {"sign": np.where(rng.random((n, 1)) < 0.5, -1.0, 1.0).astype(np.float32),
            "sigma": sigma,
            "noise": (rng.standard_normal((n, 2048)) * sigma[:, None]).astype(np.float32)}


def _state(payload):
    """A gathered checkpoint payload as _port_state's dict of dicts."""
    opt = payload["optimizer"]
    return {"params": payload["network"], "ema": payload["ema"], "mu": opt["mu"],
            "nu": opt["nu"]}


# Tolerances, as tests/test_torch_trainer.py's (f32, both frameworks summing
# in their own orders; DDP and FSDP average the two ranks' gradients): loss,
# pre-clip gradient norm and its EMA 1e-5 relative; the loss statistics 1e-4;
# the parameter update and the EMA's move 2e-3 relative in L2 and each
# element within 10% of the largest step; Adam's moments 1e-3 relative in L2.
@pytest.mark.parametrize("mode,wrapper,program", [("dp", "DistributedDataParallel", False),
                                                  ("dp", "DistributedDataParallel", True),
                                                  ("fsdp", "FSDPUnetCQT", False)])
def test_data_parallel_steps_match_jax(train_runs, mode, wrapper, program):
    """The DDP step eagerly and through its step program (head, all-reduce,
    tail), and the FSDP step (eager over gloo, by rule)."""
    mode += "_program" if program else ""
    run = train_runs["ranks"][0][mode]
    assert run["wrapper"] == wrapper
    for got, ref in zip(run["metrics"], train_runs["jax_metrics"]):
        for k in ("loss", "grad_norm", "gnorm_ema"):
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
        assert float(got["skipped"]) == 0.0
        np.testing.assert_array_equal(got["sigma_bins"][:, 0], np.asarray(ref["sigma_bins"])[:, 0])
        np.testing.assert_allclose(got["sigma_bins"], np.asarray(ref["sigma_bins"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["loss_moments"], np.asarray(ref["loss_moments"]),
                                   rtol=1e-4)
    # both ranks report the global batch's numbers
    other = train_runs["ranks"][1][mode]["metrics"]
    for a, b in zip(run["metrics"], other):
        np.testing.assert_array_equal(a["grad_norm"], b["grad_norm"])
        np.testing.assert_array_equal(a["sigma_bins"], b["sigma_bins"])
    assert train_runs["ranks"][1][mode]["state"] is None    # rank 0 gathers
    got, ref, p0 = _state(run["state"]), train_runs["jax_state"], train_runs["p0"]
    moved = max(float((ref["params"][n] - p0[n]).abs().max()) for n in p0)
    assert moved > 0
    for k in ("params", "ema"):
        assert _rel_l2(got[k], ref[k], p0) <= 2e-3, k
        assert max(float((got[k][n] - ref[k][n]).abs().max()) for n in p0) <= 0.1 * moved, k
    for k in ("mu", "nu"):
        assert _rel_l2(got[k], ref[k]) <= 1e-3, k


@pytest.mark.parametrize("program", [False, True])
def test_dp_gradient_accumulation_matches_one_rank(train_runs, program):
    """Two micro-batches a step under DDP (no sync but on the last), eagerly
    and through the step program (both micro-batches in its head, one
    all-reduce): the one-rank trainer's steps (held to JAX by
    tests/test_torch_trainer.py), loss and norm within 1e-5, the state
    within 1e-4 relative in L2."""
    ref_metrics, ref = train_runs["accumulate"]
    run = train_runs["ranks"][0]["dp_accumulate2" + ("_program" if program else "")]
    assert run["step_programs_built"] == int(program)
    for got, want in zip(run["metrics"], ref_metrics):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    got = _state(run["state"])
    for k in ("params", "ema"):
        assert _rel_l2(got[k], ref[k], train_runs["p0"]) <= 1e-4, k
    for k in ("mu", "nu"):
        assert _rel_l2(got[k], ref[k]) <= 1e-4, k


@pytest.mark.parametrize("accumulate", [False, True])
def test_the_dp_program_equals_the_ddp_step(train_runs, accumulate):
    """Through its step program (one build, then replays) a dp run ends
    where the eager DDP run ends, bit for bit: the head scales each rank's
    gradients by 1/2 as DDP scales them into its buckets, and the two
    ranks' sum is the same sum."""
    name = "dp_accumulate2" if accumulate else "dp"
    eager, prog = (train_runs["ranks"][0][name + s] for s in ("", "_program"))
    assert prog["step_programs_built"] == 1
    for got, want in zip(prog["metrics"], eager["metrics"]):
        for k in ("loss", "grad_norm", "gnorm_ema", "sigma_bins", "loss_moments"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = _state(prog["state"]), _state(eager["state"])
    for k in got:
        for n in got[k]:
            assert torch.equal(got[k][n], want[k][n]), (k, n)


def test_programs_follow_the_rule_under_gloo(train_runs):
    """At world 2 over gloo: a dp trainer runs programs, an FSDP trainer
    eagerly (gloo's collectives cannot sit inside its one graph). With
    the stream reading as capturing, the dp program's head and tail make
    no collective and its all-reduce, like every collective of the port
    over gloo, raises and names the backend."""
    for rank in train_runs["ranks"]:
        assert rank["dp"]["programs_enabled"] and rank["dp_program"]["programs_enabled"]
        assert not rank["fsdp"]["programs_enabled"]
        assert rank["fsdp"]["step_programs_built"] == 0
        assert rank["dp_program"]["step_programs_built"] == 1
        cap = rank["dp_program"]["capturing"]
        assert cap["head"] == cap["tail"] == "no error"
        assert "gloo collective" in cap["reduce"]


def test_fsdp_state_is_sharded(train_runs):
    """Every parameter of at least 256 elements with a dim divisible by 2 is
    half on each rank, and so are its EMA and both Adam moments; the rest
    are whole."""
    run = train_runs["ranks"][0]["fsdp"]
    frac = run["local_fraction"]
    dims = run["shard_dims"]
    assert sum(d is not None for d in dims) >= 10
    for k in ("params", "ema", "mu", "nu"):
        assert frac[k] == [0.5 if d is not None else 1.0 for d in dims], k
    assert run["local_fraction"] == train_runs["ranks"][1]["fsdp"]["local_fraction"]


def test_fsdp_checkpoint_at_world2_resumes_at_world1(train_runs):
    """The step-2 checkpoint of the 2-rank FSDP run is the one-device layout;
    a one-rank trainer resumed from it takes step 3 on the same global batch
    and draws and ends where the uninterrupted 2-rank run ends (the update
    within 1e-4 relative in L2: the same steps, averaged over the ranks in
    another order)."""
    path = train_runs["ranks"][0]["saved_at_2"]
    assert path == train_runs["ranks"][1]["saved_at_2"] and path.endswith("22k_8s-2.pt")
    saved = ckpt.load(path)
    assert saved["it"] == 2 and saved["optimizer"]["count"] == 2
    assert {n: tuple(t.shape) for n, t in saved["network"].items()} == \
        {n: tuple(t.shape) for n, t in train_runs["sd"].items()}
    tr = _port(train_runs["tmp"], TINY, train_runs["sd"], sub="resume_w1")
    assert tr.resume_from_checkpoint(path) and tr.it == 2
    audio, fs, draws = train_runs["steps"][2]
    tr.train_step(audio[0], fs[0], draws)
    got = _port_state(tr)
    ref = _state(train_runs["ranks"][0]["fsdp"]["state"])
    for k in ("params", "ema"):
        assert _rel_l2(got[k], ref[k], train_runs["p0"]) <= 1e-4, k
    for k in ("mu", "nu"):
        assert _rel_l2(got[k], ref[k]) <= 1e-4, k


def test_world1_checkpoint_resumes_under_fsdp(train_runs):
    """The other way round: the one-rank run's step-2 checkpoint resumed by
    the 2-rank FSDP group ends step 3 where the one-rank run does."""
    got = _state(train_runs["ranks"][0]["resumed_from_world1"])
    ref = train_runs["world1"]
    for k in ("params", "ema"):
        assert _rel_l2(got[k], ref[k], train_runs["p0"]) <= 1e-4, k
    for k in ("mu", "nu"):
        assert _rel_l2(got[k], ref[k]) <= 1e-4, k


# ------------------------------------------------- attention, tp and serving

NET = dict(O=tu.O, bins=tu.BINS, fs=tu.FS, len=tu.LEN, Ns=tu.NS, num_dils=tu.NUM_DILS,
           att_layers=tu.ATT_LAYERS, emb=tu.EMB, gelu="tanh")
EDM = dict(sigma_data=0.063, sigma_min=1e-4, sigma_max=1.0, rho=13.0, Schurn=10.0)
SERVE = ["exp=test_cqtdiff_22k", "exp.audio_len=2048", "network.cqt.num_octs=3",
         "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]", "network.num_dils=[1,1,1]",
         "network.attention_layers=[0,0,1,1]", "network.compute_dtype=float32", "tester.T=4",
         # the deterministic operating point, as tests/test_tp.py: with churn
         # a random network's guided trajectory is chaotic
         "tester.diff_params.same_as_training=False", "tester.diff_params.Schurn=0.0"]


def _ring_case():
    key = jax.random.PRNGKey(0)
    B, H, T, D = 2, 4, 64, 16
    q, k, v = (np.asarray(jax.random.normal(kk, (B, H, T, D))) for kk in jax.random.split(key, 3))
    bias = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (1, H, T, T)) * 0.3)
    return dict(q=q, k=k, v=v, bias=bias)


def _jax_ring(case):
    """JAX's ring attention over the 8-device cp mesh: output and the
    gradients of sum(sin(output))."""
    mesh = Mesh(np.array(jax.devices()), ("cp",))
    args = [jnp.asarray(case[n]) for n in ("q", "k", "v", "bias")]

    def f(q, k, v, b):
        return jnp.sum(jnp.sin(jring.ring_attention(q, k, v, mesh, bias=b)))

    y = jring.ring_attention(*args[:3], mesh, bias=args[3])
    grads = jax.grad(f, argnums=(0, 1, 2, 3))(*args)
    return dict(y=np.asarray(y), **{n: np.asarray(g) for n, g in
                                    zip(("dq", "dk", "dv", "dbias"), grads)})


def _serve_case():
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(3 * 2048) * 0.05).astype(np.float32)
    mask = np.ones_like(audio)
    for a, b in ((300, 380), (2600, 2700), (5200, 5300)):   # rounds of 2 rows and 1
        mask[a:b] = 0.0
    return dict(overrides=SERVE, max_batch=2, audio=audio, mask=mask, fs=22050, seed=3)


@pytest.fixture(scope="module")
def attention_runs(tmp_path_factory):
    """The 2-rank group and the 4-rank dp x tp group run while this process
    computes the JAX references and the one-rank served answer."""
    tmp = str(tmp_path_factory.mktemp("attn"))
    ring = _ring_case()
    jparams = jax.tree_util.tree_map(jnp.asarray, tu.trained_like(jax.jit(
        tu.jax_model("tanh").init)(jax.random.PRNGKey(7), jnp.zeros((1, tu.LEN)),
                                   jnp.zeros((1, 1)))))
    sd = state_dict_from_flax(jparams)
    audio, cnoise = tu.inputs(5)
    w = np.random.default_rng(6).standard_normal(audio.shape).astype(np.float32)
    attn_cp = dict(tu.ATTN, context_parallel=True)
    y, mask = _masked(audio[:1])
    x = (np.random.default_rng(5).standard_normal(y.shape) * 0.5).astype(np.float32)
    t = np.float32(0.5)
    serve = _serve_case()
    groups = [
        Group("attention", 2, os.path.join(tmp, "group"), {
            "ring": ring,
            "cp": dict(net=NET, attn=attn_cp, state_dict=sd, audio=audio, cnoise=cnoise, w=w),
            "tp": dict(net=NET, attn=dict(tu.ATTN), state_dict=sd, audio=audio,
                       cnoise=cnoise, edm=EDM, x=x, y=y, mask=mask, t=t),
            "serve": serve}),
        Group("serve_dp_tp", 4, os.path.join(tmp, "dp_tp"), {"serve": serve})]

    # the U-Net with cp attention over 2 of the 8 devices, and its input gradient
    jcp = tu.JaxUnet(cqt=tu.jax_get_cqt(tu.O, tu.BINS, tu.FS, tu.LEN), Ns=tu.NS,
                     num_dils=tu.NUM_DILS, attention_layers=tu.ATT_LAYERS, attention=attn_cp,
                     emb_dim=tu.EMB, gelu="tanh")
    jring.set_cp_mesh(Mesh(np.array(jax.devices()[:2]), ("cp",)))
    try:
        y_cp = np.asarray(jax.jit(jcp.apply)(jparams, jnp.asarray(audio), jnp.asarray(cnoise)))
    finally:
        jring.set_cp_mesh(None)
    plain = tu.jax_model("tanh")
    dx = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(
        plain.apply(jparams, xx, jnp.asarray(cnoise)) * w)))(jnp.asarray(audio)))
    # the guided score, as tests/test_torch_sampler.py's
    jp = jedm.EDMParams(**EDM)

    def jscore(params, xx):
        def denoise(a, tt):
            sig = jnp.broadcast_to(jnp.asarray(tt, jnp.float32), (a.shape[0], 1))
            return jedm.denoiser(jp, lambda b, c: plain.apply(params, b, c), a, sig)
        return jheun.make_score_fn(jp, jheun.SamplerConfig(), denoise, y=jnp.asarray(y),
                                   degradation=jdegr.time_mask(jnp.asarray(mask)),
                                   proj=jdegr.inpainting_projector(jnp.asarray(y),
                                                                  jnp.asarray(mask)),
                                   hpf=plain.cqt.apply_hpf_DC)(xx, t)[0]

    jax_ref = dict(
        ring=_jax_ring(ring), cp_y=y_cp, cp_dx=dx,
        tp_y=np.asarray(jax.jit(plain.apply)(jparams, jnp.asarray(audio), jnp.asarray(cnoise))),
        tp_score=np.asarray(jax.jit(jscore)(jparams, jnp.asarray(x))))
    one = InpaintingService.from_config(SERVE, device="cpu", max_batch=2)
    rounds = []
    run = one._run_batch
    one._run_batch = lambda xb, mb, seed: rounds.append(xb.shape[0]) or run(xb, mb, seed)
    single = one.inpaint(serve["audio"], serve["mask"], serve["fs"], seed=serve["seed"])
    ranks, dp_tp = (g.results() for g in groups)
    return dict(jax=jax_ref, single=single, single_rounds=rounds, serve=serve, sd=sd,
                ranks=ranks, dp_tp=dp_tp)


def _masked(audio):
    mask = np.ones_like(audio)
    mask[:, 800:1200] = 0.0
    return audio * mask, mask


def test_ring_attention_matches_jax(attention_runs):
    """2-rank ring attention with a bias against JAX's 8-device ring (itself
    held to dense attention at 2e-6 / 2e-5 by tests/test_parallel.py):
    output within 2e-6, gradients of sum(sin(y)) within 2e-5 absolute, on
    every rank."""
    ref = attention_runs["jax"]["ring"]
    for r in attention_runs["ranks"]:
        np.testing.assert_allclose(r["ring"]["y"], ref["y"], atol=2e-6)
        for g in ("dq", "dk", "dv", "dbias"):
            np.testing.assert_allclose(r["ring"][g], ref[g], atol=2e-5, err_msg=g)


def test_unet_with_cp_attention_matches_jax(attention_runs):
    """The U-Net with attention_dict.context_parallel over a 2-rank cp mesh:
    every attention layer went round the ring; the forward against JAX's cp
    forward and the input gradient against JAX's (relative 1e-4 of the
    largest value, as tests/test_torch_unet.py)."""
    ref = attention_runs["jax"]
    for r in attention_runs["ranks"]:
        cp = r["cp"]
        assert len(cp["ring_T"]) == 2 * sum(tu.ATT_LAYERS[:-1]) + tu.ATT_LAYERS[-1]
        assert all(t % 2 == 0 for t in cp["ring_T"])
        assert tu.rel_err(cp["y"], ref["cp_y"]) < tu.REL_TOL
        assert tu.rel_err(cp["dx"], ref["cp_dx"]) < tu.REL_TOL


def test_tp_forward_and_guided_score_match_jax(attention_runs):
    """The tp=2 U-Net keeps half of every split weight; its forward and one
    guided score (forward, input gradient through every gather, guidance
    normalisation, projection) against JAX's, on every rank (relative 1e-4
    and 1e-5 of the largest value, as tests/test_torch_unet.py and
    tests/test_torch_sampler.py)."""
    ref = attention_runs["jax"]
    sd = attention_runs["sd"]
    for r in attention_runs["ranks"]:
        t = r["tp"]
        split = [n for n, v in t["placements"].items() if v == "shard0"]
        assert len(split) >= 10
        for n in split:
            assert t["local_fraction"][n] == sd[n].shape[0] // 2
        assert tu.rel_err(t["y"], ref["tp_y"]) < tu.REL_TOL
        assert tu.rel_err(t["score"], ref["tp_score"]) < 1e-5


# The one-rank port answer is held to JAX by tests/test_torch_serving.py and
# tests/test_torch_sampler.py. A split batch changes only which rows share a
# batch, so the answers agree to f32 rounding through T=4 deterministic
# steps: 1e-5 absolute on a signal of amplitude ~0.2.
SERVE_TOL = 1e-5


def _check_served(got, attention_runs, n_dp):
    serve = attention_runs["serve"]
    single = attention_runs["single"]
    observed = serve["mask"] > 0.5
    np.testing.assert_array_equal(got["out"][observed], serve["audio"][observed])
    np.testing.assert_allclose(got["out"], single, atol=SERVE_TOL)
    assert got["max_batch"] % n_dp == 0
    assert got["rounds"] == attention_runs["single_rounds"]


def test_shard_dp_serves_the_one_rank_answer(attention_runs):
    """A dp=2 mesh: each rank runs its row of every round through its own
    program (one row a rank: one program) and returns the whole answer."""
    for r in attention_runs["ranks"]:
        _check_served(r["serve_dp"], attention_runs, 2)
        assert r["serve_dp"]["programs_enabled"] and r["serve_dp"]["program_rows"] == [1]


def test_shard_dp_tp_serves_the_one_rank_answer(attention_runs):
    """A dp=2 x tp=2 mesh (4 ranks): every rank returns the whole answer,
    its trajectories run eagerly (the split layers' collectives sit inside
    every score)."""
    for r in attention_runs["dp_tp"]:
        _check_served(r["served"], attention_runs, 2)
        assert not r["served"]["programs_enabled"] and r["served"]["program_rows"] == []


def test_collectives_raise_while_capturing_over_gloo(attention_runs):
    """Every collective of the port's step and score, called over gloo with
    the stream reading as capturing, raises and names the backend instead
    of running on the host at capture time."""
    for r in attention_runs["ranks"]:
        assert set(r["capturing"]) == {"all_reduce", "all_gather", "sum_over_ranks", "ring_hop"}
        for name, msg in r["capturing"].items():
            assert "a gloo collective was called while a CUDA graph is being captured" in msg, \
                name


def test_shard_needs_a_group_and_full_score_cp_raises():
    """Without a process group shard raises, also for a network built with
    network.context_parallel (full-score cp, ported: tests/test_torch_cp.py),
    whose flag without a cp mesh changes nothing. (A tp x cp mesh and
    autotune_max_batch after shard raise in the 4-rank group.)"""
    svc = InpaintingService(args=compose(overrides=SERVE), network=None, sampler=None)
    with pytest.raises(RuntimeError, match="process group"):
        svc.shard()
    assert tunet.build_unet(tu._net_args(context_parallel=True)).context_parallel
    assert pring.get_cp_mesh() is None


def test_refusals_under_a_group(attention_runs):
    """A tp x cp mesh, and autotune_max_batch over a tp mesh (its
    trajectories run eagerly: no program to measure), raise."""
    for r in attention_runs["dp_tp"]:
        assert r["refused"] == {"tp_cp_mesh": "ValueError", "autotune": "RuntimeError"}


def test_autotune_over_dp_agrees_on_the_tightest_rank(attention_runs):
    """Over a dp=4 mesh each rank fits 8, 4, 2 and 2 rows (stand-in
    footprints); every rank returns the tightest rank's rows times the dp
    size, and max_batch (4 after shard) is not raised."""
    for r in attention_runs["dp_tp"]:
        assert r["autotuned"] == {"rows": 8, "max_batch": 4}
