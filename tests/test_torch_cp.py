"""Full-score context parallelism of the port (``aid_tpu_torch.parallel.cp``,
``network.context_parallel``) against the unsharded port and the JAX
package, on the CPU.

One 2-rank and one 4-rank gloo group of tests/torch_dist_worker.py (job
``cp``; every rank in one cp group) run while this process computes the JAX
references:

  * the pieces, each against its unsharded version (values and input
    gradients): the (5, 3) conv with its one-frame halos, the FIR resampler
    down and up with its 3-frame halos (reflected at the global edges), the
    group std with its moments all-reduced, and the ring in its local mode
    against dense attention;
  * the full score at cp=2 and cp=4: the tiny net of tests/test_cp_full.py
    (3 octaves, 8 bins, 2048 samples, Ns=[8,16,16], attention on the two
    deepest levels, with a relative-position bias here), weights from JAX
    with trained-like gates, forward and the input gradient of sum(y^2)
    against JAX's unsharded ``apply`` and ``grad``; every level sharded and
    the exchanges counted;
  * ``InpaintingService.inpaint`` over a dp=2 x cp=2 mesh (4 ranks) at
    tester.T=8, Schurn=0, with JAX's noise injected, against the one-device
    port and JAX's one-device service (as tests/test_cp_full.py:80-135);
    ``shard`` refuses a tp x cp mesh.

Everything is f32; each tolerance is stated where it is used.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu import setup as asetup
from aid_tpu.serving import InpaintingService as JaxService
from aid_tpu.utils.config import compose as jcompose
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.serving import InpaintingService
from aid_tpu_torch.utils.config import compose
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests import test_torch_unet as tu
from tests.test_torch_qconv import INT8_TOL
from tests.test_torch_sampler import _jax_noise
from tests.torch_dist_worker import Group
from tests.torch_threads import one_torch_thread  # noqa: F401

L = 2048
NET = ["exp=test_cqtdiff_22k", f"exp.audio_len={L}", "network.cqt.num_octs=3",
       "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]", "network.num_dils=[1,1,1]",
       "network.attention_layers=[0,0,1,1]", "network.attention_dict.use_rel_pos=True",
       "network.compute_dtype=float32"]
CP_FLAGS = ["network.context_parallel=True", "network.attention_dict.context_parallel=True"]
SERVE = NET + ["tester.T=8", "tester.diff_params.same_as_training=False",
               "tester.diff_params.Schurn=0.0"]
# per-octave frame counts of the tiny net (T = 256, 128, 64): 3 levels
LEVELS = 3


def _jax_bundle(overrides, tmp):
    b = asetup.setup_network(jcompose(overrides=overrides + [f"model_dir={tmp}"]))
    b.init(jax.random.PRNGKey(0), 1, L)
    b.params = jax.tree_util.tree_map(jnp.asarray, tu.trained_like(jax.device_get(b.params)))
    return b


def _pieces():
    rng = np.random.default_rng(0)
    B, F_, T, C = 2, 12, 32, 6
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f32(B, F_, T, C), conv_w=f32(5, 6, 5, 3) * 0.2, dilation=4,
                w_conv=f32(B, F_, T, 5), w_down=f32(B, F_, T // 2, C),
                w_up=f32(B, F_, 2 * T, C), w_x=f32(B, F_, T, C),
                ring=dict(q=f32(2, 2, T, 8), k=f32(2, 2, T, 8), v=f32(2, 2, T, 8),
                          bias=f32(1, 2, T, T) * 0.3))


def _serve_case():
    """Two gaps whose windows hold them at the same place (one round of two
    rows, identical masks: the JAX package smooths row 0's mask for every
    row, ROADMAP section 3)."""
    audio = (np.random.default_rng(1).standard_normal(3 * L) * 0.05).astype(np.float32)
    mask = np.ones_like(audio)
    mask[1000:1100] = 0.0
    mask[4000:4100] = 0.0
    return audio, mask


@pytest.fixture(scope="module")
def cp_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cp"))
    b = _jax_bundle(NET, os.path.join(tmp, "jax"))
    sd = state_dict_from_flax(jax.device_get(b.params))
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, L)) * 0.1).astype(np.float32)
    cnoise = np.full((2, 1), 0.05, np.float32)
    serve_audio, serve_mask = _serve_case()
    key = jax.random.split(jax.random.PRNGKey(3))[1]     # the service's first round
    prior, churn = _jax_noise(key, (2, L), 8)
    score = dict(overrides=NET + CP_FLAGS, state_dict=sd, audio=audio, cnoise=cnoise)
    serve = dict(overrides=SERVE, state_dict=sd, max_batch=2, audio=serve_audio,
                 mask=serve_mask, fs=22050, prior=prior, churn=churn)
    groups = {n: Group("cp", n, os.path.join(tmp, f"world{n}"),
                       {"pieces": _pieces(), "score": score, "serve": serve})
              for n in (2, 4)}

    y_ref = np.asarray(jax.jit(b.module.apply)(b.params, jnp.asarray(audio), jnp.asarray(cnoise)))
    g_ref = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(
        b.module.apply(b.params, xx, jnp.asarray(cnoise)) ** 2)))(jnp.asarray(audio)))

    jargs = jcompose(overrides=SERVE + [f"model_dir={os.path.join(tmp, 'jserve')}"])
    jsvc = JaxService(args=jargs, bundle=b, max_batch=2, sampler=asetup.setup_sampler(
        jargs, network=b, diff_params=asetup.setup_diff_parameters(jargs)))
    jax_served = jsvc.inpaint(serve_audio, serve_mask, 22050, seed=3)

    args = compose(overrides=SERVE)
    net = tsetup.setup_network(args, device="cpu", state_dict=sd)
    one = InpaintingService(args=args, network=net, max_batch=2, sampler=tsetup.setup_sampler(
        args, net, tsetup.setup_diff_parameters(args)))
    predict = one.sampler.predict_inpainting
    one.sampler.predict_inpainting = lambda y, m, generator=None: predict(
        y, m, prior=torch.from_numpy(prior), churn=torch.from_numpy(churn))
    one_served = one.inpaint(serve_audio, serve_mask, 22050, seed=3)
    return dict(ranks={n: g.results() for n, g in groups.items()}, y_ref=y_ref, g_ref=g_ref,
                jax_served=jax_served, one_served=one_served, serve=serve)


# -------------------------------------------------------------- the pieces

# The sharded pieces run the same arithmetic as the unsharded ones but for
# the resampler (a depthwise filter over halos against the banded matrix)
# and the moments (a mean of equal blocks' means): f32 reassociation,
# 1e-5 of the largest value.
PIECE_TOL = 1e-5


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("piece", ["conv", "resample_upFalse", "resample_upTrue", "group_std"])
def test_sharded_piece_matches_unsharded(cp_runs, world, piece):
    for r in cp_runs["ranks"][world]:
        got, ref = r["pieces"][piece]
        assert got["y"].shape == ref["y"].shape
        assert tu.rel_err(got["y"], ref["y"]) < PIECE_TOL
        assert tu.rel_err(got["dx"], ref["dx"]) < PIECE_TOL


@pytest.mark.parametrize("world", [2, 4])
def test_local_ring_matches_dense(cp_runs, world):
    """The ring in its local mode (this rank's q, k, v blocks and bias
    rows), gathered: dense attention's output within 2e-6; the gradients of
    sum(sin(y)) (the bias gradient summed over the ranks' rows) within 2e-5
    of dense attention's autograd (the tolerances of
    tests/test_torch_parallel.py's ring test)."""
    ranks = cp_runs["ranks"][world]
    for r in ranks:
        ring = r["pieces"]["ring"]
        np.testing.assert_allclose(ring["y"], ring["dense"], atol=2e-6)
    inp = _pieces()["ring"]
    q, k, v, bias = (torch.from_numpy(inp[n]).requires_grad_(True) for n in ("q", "k", "v", "bias"))
    s = torch.matmul(q, k.transpose(-1, -2)) * 0.25 + bias
    torch.sin(torch.matmul(torch.softmax(s, -1), v)).sum().backward()
    dbias = sum(r["pieces"]["ring"]["dbias"] for r in ranks)
    np.testing.assert_allclose(dbias, bias.grad.numpy(), atol=2e-5)
    for r in ranks:
        for n, t in (("dq", q), ("dk", k), ("dv", v)):
            np.testing.assert_allclose(r["pieces"]["ring"][n], t.grad.numpy(), atol=2e-5,
                                       err_msg=n)


# ---------------------------------------------------------- the full score


@pytest.mark.parametrize("world", [2, 4])
def test_full_score_matches_jax_unsharded(cp_runs, world):
    """Every level split over the cp group (T/n = 128/64/32 frames at cp=2,
    64/32/16 at cp=4): forward and the input gradient of sum(y^2) against
    JAX's unsharded apply and grad within 1e-4 of the largest value (as
    tests/test_torch_unet.py), on every rank."""
    for r in cp_runs["ranks"][world]:
        s = r["score"]
        assert np.abs(cp_runs["y_ref"]).max() > 1e-4
        assert tu.rel_err(s["y"], cp_runs["y_ref"]) < tu.REL_TOL
        assert tu.rel_err(s["dx"], cp_runs["g_ref"]) < tu.REL_TOL


@pytest.mark.parametrize("world", [2, 4])
def test_full_score_shards_every_level(cp_runs, world):
    """The sharding is not a silent no-op: every level split, one shard per
    octave entry, one gather per decoder octave, a halo for each (5, 3)
    conv (the 3 down_i_pyr and 2 x (1 + 1 + 1) + 1 stacks' convs) and each
    of the 4 resamples, each exchanged again in the backward; the moments
    all-reduced; the three attention layers ringed."""
    convs = 3 + 7
    for r in cp_runs["ranks"][world]:
        c = r["score"]["counts"]
        assert c["levels_sharded"] == LEVELS and "levels_replicated" not in c
        assert c["shard"] == LEVELS and c["gather"] == LEVELS
        assert c["halo"] == convs + 4 and c["halo_bwd"] == c["halo"]
        assert c["ring"] == 3
        assert c["moments"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_full_score_int8_matches_unsharded_int8(cp_runs, world):
    """int8 under cp: each quantizer's per-sample scale is the max over the
    whole time axis (all-reduced), so the sharded net quantizes as the
    unsharded one; the float parts reassociate, which can move a value on a
    rounding boundary by one step: within tests/test_torch_qconv.py's
    INT8_TOL, forward and input gradient."""
    for r in cp_runs["ranks"][world]:
        got, ref = r["score_int8"]
        assert got["counts"]["levels_sharded"] == LEVELS
        assert tu.rel_err(got["y"], ref["y"]) < INT8_TOL
        assert tu.rel_err(got["dx"], ref["dx"]) < INT8_TOL


# ---------------------------------------------------------------- serving

# The one-device port against JAX's service on the same noise: T=8
# deterministic steps of guided sampling, each package summing in its own
# order; 1e-4 absolute on audio of amplitude ~0.2. dp x cp against the
# one-device port: the same arithmetic but for the moments' and the
# resampler's reassociation and the ring's; 1e-5 absolute.
JAX_SERVE_TOL = 1e-4
CP_SERVE_TOL = 1e-5


def test_dp_cp_inpaint_matches_one_device(cp_runs):
    s = cp_runs["serve"]
    observed = s["mask"] > 0.5
    one, ref = cp_runs["one_served"], cp_runs["jax_served"]
    np.testing.assert_allclose(one, ref, atol=JAX_SERVE_TOL)
    for r in cp_runs["ranks"][4]:
        got = r["serve_dp_cp"]
        assert got["args_flag"] is True and got["flags"] and all(got["flags"])
        assert got["max_batch"] == 2 and got["counts"]["levels_sharded"] > 0
        np.testing.assert_array_equal(got["out"][observed], s["audio"][observed])
        np.testing.assert_allclose(got["out"], one, atol=CP_SERVE_TOL)
        np.testing.assert_allclose(got["out"], ref, atol=JAX_SERVE_TOL)


def test_shard_refuses_a_tp_cp_mesh(cp_runs):
    for r in cp_runs["ranks"][4]:
        assert "tp x cp" in r["tp_cp"]
