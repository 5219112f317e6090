"""EDM training of the U-Net on one CUDA device or a data-parallel group.

Port of ``aid_tpu/training/trainer.py``. One iteration: the host batch goes
to the device, rows at another rate are resampled there and cropped to the
model length, a per-row polarity flip, the EDM loss (sigma and noise drawn
from the trainer's ``torch.Generator``), gradients summed over
``num_accumulation_rounds`` micro-batches, the pre-clip global norm, the
global-norm clip, Adam, the LR ramp, the skip guardrails, the EMA of the
parameters and the loss statistics. The loop around it logs, checkpoints,
resumes, samples demos with the EMA weights through the tester, profiles
and guards against stalls and host-memory growth, as the JAX trainer does.

The optimizer is written as tensor ops (``torch._foreach_*``) and not as
``torch.optim.Adam``, because the JAX step's semantics need it:
  * optax's ``scale_by_schedule`` reads the step count before incrementing
    it, so the first update has learning rate 0 and leaves the parameters
    as they were;
  * optax clips to ``g max / |g|`` when ``|g| >= max``; PyTorch's
    ``clip_grad_norm_`` divides by ``|g| + 1e-6``;
  * a step the guardrail skips keeps the parameters, both moments and the
    step count, chosen on the device with ``torch.where`` and no host sync.

Random draws (the polarity sign, sigma, the noise) can be injected per
micro-batch, so a test can feed this trainer and the JAX one the same draws.

The step is one function of device tensors (``_step``: the micro-batch
forward and backward passes, clipping, Adam, the guardrails, the EMA and
the metrics). The host does what varies from step to step first, in the
eager order: each micro-batch goes to the device, is resampled, and draws
its sign, sigma and noise from ``self.gen``; the EMA's rate comes from the
iteration count. The step runs as a ``training.program.StepProgram``,
one per (input shapes and dtypes, fused function, TF32 and remat settings)
over the current state tensors, the counterpart of the JAX step's
``jax.jit`` with donation: on CUDA CUDA graphs replayed every step, on the
CPU the same functions eagerly over the same buffers (the eager step bit
for bit). ``compile_step`` builds it without training. A new state
tensor, a resume or an in-place load (address or version of a parameter,
moment, EMA, counter or buffer) drops the program. Under a process group
``programs_enabled`` says which steps a capture can hold: a dp step as two
graphs around its gradient all-reduce (``_dp_head``, ``_dp_reduce``,
``_dp_tail``), an FSDP2 step under NCCL as one; the rest run eagerly.

Under a process group (``parallel.mesh.init_distributed``) the global batch
``exp.batch`` is split over a ``"dp"`` mesh of ranks, each of which takes its
``local_batch_size`` rows from its own data stream:
  * dp: the module runs under DDP (gradients averaged over the ranks, no
    sync on every micro-batch but the last), so every rank holds the
    global-batch gradient and takes the same step;
  * fsdp (``exp.mesh.fsdp``): FSDP2 shards every parameter of at least
    ``exp.mesh.fsdp_min_size`` elements on its largest dim divisible by the
    dp size (``parallel.mesh.fsdp_shard_dim``); the EMA and both Adam moments
    live as the same shards, and the optimizer runs on the local shards. The
    smaller parameters stay replicated and their gradients are averaged
    here. The pre-clip norm is the all-reduced sum of the local squares.
The clip, the guardrails (the finite check included) and the EMA then read
numbers that are the same on every rank. The loss statistics are summed over
the ranks; logging, demos and checkpoint writes run on rank 0 (an FSDP
checkpoint is gathered there first, in the one-device layout).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import sys
import time
import traceback
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.parallel import mesh as pmesh
from aid_tpu_torch.training import stats as tstats
from aid_tpu_torch.training import utils as tutils
from aid_tpu_torch.training.program import StepProgram
from aid_tpu_torch.utils.graphs import capture_flags, capture_stream, specs, tensors_key
from aid_tpu_torch.utils import checkpoint as ckpt
from aid_tpu_torch.utils import logging_utils as logu


class Trainer:
    """Training orchestrator built from the config tree
    (``exp.trainer_callable``): ``network`` is the trainable module
    (``setup.setup_network(..., trainable=True)``), ``dset`` an iterator of
    host batches (audio [B, T], fs [B])."""

    def __init__(self, args, dset=None, network=None, diff_params=None, tester=None):
        self.args = args
        self.exp = exp = args.exp
        self.dset = dset
        self.tester = tester
        self._demo_failures = 0
        quant = str(args.network.get("quant", "none"))
        if quant != "none":
            raise ValueError(f"network.quant={quant} is a serving-only path; train with "
                             "network.quant=none")
        self._pin_mmap_threshold()
        self.net = network
        self.p = diff_params.params if hasattr(diff_params, "params") else diff_params
        named = list(network.named_parameters())
        self.names = [n for n, _ in named]
        self.device = named[0][1].device
        self.groups = sorted({n.split(".")[0] for n in self.names})

        self.n_accum = int(exp.get("num_accumulation_rounds", 1))
        self.batch = int(exp.batch)
        self._setup_parallel(exp.get("mesh", {}) or {})
        self.audio_len = int(exp.audio_len)
        self.target_fs = int(exp.sample_rate)
        self.aug_cfg = exp.get("augmentations", None)
        self.base_lr = float(exp.lr)
        self.rampup = max(int(exp.lr_rampup_it), 1)
        opt = exp.optimizer
        self.b1, self.b2, self.eps = float(opt.beta1), float(opt.beta2), float(opt.eps)
        # the bias corrections' bases, on the device once (no copy in the step)
        self._b1t = torch.tensor(self.b1, device=self.device)
        self._b2t = torch.tensor(self.b2, device=self.device)
        self.use_clip = bool(exp.get("use_grad_clip", True))
        self.max_norm = float(exp.max_grad_norm)
        self.skip_gnorm = float(exp.get("skip_grad_norm", 0) or 0)
        self.skip_factor = float(exp.get("skip_grad_factor", 0) or 0)
        self.ema_rate = float(exp.ema_rate)
        self.ema_rampup = exp.get("ema_rampup", None)
        self.total_its = int(exp.get("total_its", 10 ** 9))
        # exit when no iteration completes in this window (0 disables); a
        # relaunch resumes from the latest checkpoint
        self.stall_timeout_s = float(exp.get("stall_timeout_s", 1800.0))

        logging = args.logging
        self.lead = pmesh.rank() == 0     # logs, demos and writes checkpoints
        self.log_interval = int(logging.get("log_interval", 1000))
        self.save_interval = int(logging.get("save_interval", 10000))
        self.heavy_log_interval = int(logging.get("heavy_log_interval", 10000))
        self.save_model = bool(logging.get("save_model", True))
        self.remove_last = bool(logging.get("remove_last_checkpoint", False))
        self.num_sigma_bins = int(logging.get("num_sigma_bins", 20))
        prof = logging.get("profiling", {}) or {}
        self.profile_enabled = bool(prof.get("enabled", False)) and self.lead
        self.profile_start = int(prof.get("start_it", 10))
        self.profile_its = int(prof.get("num_its", 3))
        self.model_dir = str(args.model_dir)
        self.profile_dir = os.path.join(self.model_dir, str(prof.get("trace_dir", "profile")))
        os.makedirs(self.model_dir, exist_ok=True)

        self.bin_edges = tstats.make_sigma_bins(self.p.sigma_min, self.p.sigma_max,
                                                self.num_sigma_bins)
        self._edges = torch.tensor(self.bin_edges, dtype=torch.float32, device=self.device)
        self.collector = tstats.Collector()
        self.plot = logu.LossBySigmaPlot()
        self._plot_count = -1

        err_filter = None
        aw = args.diff_params.get("aweighting", {}) or {}
        if bool(aw.get("use_aweighting", False)):
            err_filter = tutils.a_weighting_filter(self.target_fs, int(aw.get("ntaps", 101)))
        if bool(exp.get("use_cqt_DC_correction", False)):
            hpf = network.cqt.apply_hpf_DC
            prev = err_filter
            err_filter = (lambda e: hpf(prev(e))) if prev else hpf
        self.error_filter = err_filter

        self.wandb = logu.WandbLogger(exp.get("wandb", None) if self.lead else None,
                                      args_dict=dict(args),
                                      run_name=str(exp.get("exp_name", "")))
        # each rank draws its own sigmas and noise
        self.gen = torch.Generator(device=self.device).manual_seed(
            int(exp.get("seed", 42)) + 1000003 * pmesh.rank())
        self.it = 0
        self.ema: Optional[List[torch.Tensor]] = None
        self._step_programs: Dict[tuple, StepProgram] = {}
        self._state_seen = None         # the state key the cached programs were built over
        self.step_programs_built = 0

    # ------------------------------------------------------------- parallel

    def _setup_parallel(self, mesh_cfg) -> None:
        """The dp mesh and the module's wrapper under a process group: DDP,
        or FSDP2 with ``exp.mesh.fsdp``; the bare module otherwise.
        ``self.params`` are this rank's pieces of the parameters (plain
        tensors: FSDP's local shards), ``self.shard_dims`` the dim each is
        sharded on (None: a whole tensor)."""
        self.mesh, self.n_dp, self.fsdp = None, 1, False
        self.model = self.net
        self.shapes = [tuple(p.shape) for p in self.net.parameters()]
        self.shard_dims = [None] * len(self.names)
        if dist.is_initialized():
            self.mesh = pmesh.make_mesh(int(mesh_cfg.get("dp", -1)),
                                        batch=self.batch // self.n_accum,
                                        device_type=self.device.type)
            self.n_dp = self.mesh.size()
            self.fsdp = bool(mesh_cfg.get("fsdp", False))
            if self.fsdp:
                self._shard(int(mesh_cfg.get("fsdp_min_size", 2 ** 14)))
            elif self.n_dp > 1:
                from torch.nn.parallel import DistributedDataParallel as DDP
                cuda = self.device.type == "cuda"
                # DDP keeps every parameter's gradient accumulator, which
                # runs on the stream current when it was made: made on the
                # capture stream, the dp step program's backward can be captured
                side = capture_stream(self.device) if cuda else None
                with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                    self.model = DDP(self.net, process_group=self.mesh.get_group(),
                                     device_ids=[torch.cuda.current_device()] if cuda else None)
                if cuda:
                    torch.cuda.current_stream(self.device).wait_stream(side)
        self.params = [self._local(p) for p in self.net.parameters()]
        self.sharded = torch.tensor([d is not None for d in self.shard_dims], device=self.device)

    def _shard(self, min_size: int) -> None:
        """FSDP2 over the dp mesh: one group per residual block, one for the
        rest; the parameters under ``min_size`` elements stay whole."""
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        from aid_tpu_torch.models.unet_cqt import AdaLNResBlock
        dims = {p: pmesh.fsdp_shard_dim(tuple(p.shape), self.n_dp, min_size)
                for p in self.net.parameters()}
        self.shard_dims = [dims[p] for p in self.net.parameters()]
        whole = {p for p, d in dims.items() if d is None}
        kw = dict(mesh=self.mesh, shard_placement_fn=lambda p: Shard(dims[p]),
                  ignored_params=whole)
        for m in self.net.modules():
            if isinstance(m, AdaLNResBlock):
                fully_shard(m, **kw)
        fully_shard(self.net, **kw)
        self._whole = [p for p in self.net.parameters() if p in whole and p.requires_grad]

    @staticmethod
    def _local(t):
        """A DTensor's local shard (a view: in-place updates reach it), else t."""
        return t.to_local().detach() if hasattr(t, "to_local") else t

    def _piece(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's piece of parameter i's full tensor."""
        d = self.shard_dims[i]
        return full if d is None else full.chunk(self.n_dp, d)[self.mesh.get_local_rank()]

    def _full(self, tensors) -> Optional[List[torch.Tensor]]:
        """Full CPU tensors of per-parameter pieces, on rank 0 (None on the
        others); every rank calls it."""
        if not self.fsdp:
            return [t.detach().cpu() for t in tensors] if self.lead else None
        return pmesh.gather_to_host(tensors, self.shard_dims, self.mesh.get_group())

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier(group=self.mesh.get_group())

    # ------------------------------------------------------------------ state

    def init_state(self) -> None:
        """Fresh optimizer state around the network's current parameters:
        EMA = parameters, zero moments, step count 0."""
        with torch.no_grad():
            self.ema = [p.detach().clone() for p in self.params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)
        self.gnorm_ema = torch.zeros((), dtype=torch.float32, device=self.device)
        self.applied = torch.zeros((), dtype=torch.int64, device=self.device)
        self.it = 0
        if self.lead and bool(self.args.logging.get("print_model_summary", False)):
            from aid_tpu_torch.utils.summary import print_model_summary
            print_model_summary(zip(self.names, self.shapes))   # full shapes under FSDP

    def state_dict(self) -> Optional[Dict]:
        """The checkpoint payload (``utils/checkpoint.py`` layout), full
        tensors on the CPU, on rank 0; None on the other ranks, which take
        part in the gathers."""
        parts = [self._full(ts) for ts in (self.params, self.ema, self.mu, self.nu)]
        if not self.lead:
            return None
        net, ema, mu, nu = (dict(zip(self.names, ts)) for ts in parts)
        return {"it": self.it, "network": net, "ema": ema,
                "optimizer": {"mu": mu, "nu": nu, "count": int(self.count)},
                "gnorm_ema": float(self.gnorm_ema), "applied": int(self.applied)}

    def load_state_dict(self, payload: Dict) -> None:
        """Restore a payload. Where its parameter names or shapes differ from
        the network's, every tensor whose name and shape agree is copied, the
        rest keep their current values, and the optimizer restarts."""
        if self.ema is None:
            self.init_state()
        src, ema_src = payload["network"], payload.get("ema", payload["network"])
        same = set(src) == set(self.names) and all(
            tuple(src[n].shape) == shape for n, shape in zip(self.names, self.shapes))
        copied = 0
        with torch.no_grad():
            for i, (n, p, e) in enumerate(zip(self.names, self.params, self.ema)):
                if n in src and tuple(src[n].shape) == self.shapes[i]:
                    p.copy_(self._piece(src[n], i))
                    e.copy_(self._piece(ema_src[n], i))
                    copied += 1
                else:
                    e.copy_(p)
        if not same:
            print(f"[resume] shape-matched partial load: {copied} tensors copied", flush=True)
        opt = payload.get("optimizer") if same else None
        with torch.no_grad():
            if opt is not None:
                for i, (n, m, v) in enumerate(zip(self.names, self.mu, self.nu)):
                    m.copy_(self._piece(opt["mu"][n], i))
                    v.copy_(self._piece(opt["nu"][n], i))
                self.count.fill_(int(opt["count"]))
            else:  # the optimizer restarts on a partial load
                for t in self.mu + self.nu:
                    t.zero_()
                self.count.zero_()
        self.it = int(payload.get("it", 0))
        self.gnorm_ema.fill_(float(payload.get("gnorm_ema", 0.0)))
        self.applied.fill_(int(payload.get("applied", self.it)))

    # ------------------------------------------------------------- checkpoint

    def _ckpt_path(self, it: int) -> str:
        return os.path.join(os.path.abspath(self.model_dir), f"{self.exp.exp_name}-{it}.pt")

    def save_checkpoint(self) -> str:
        """Rank 0 writes ``{exp_name}-{it}.pt``; every rank returns its path
        once it is on disk."""
        path = self._ckpt_path(self.it)
        payload = self.state_dict()
        if self.lead:
            ckpt.save(path, payload)
            if self.remove_last:
                for old in ckpt.list_checkpoints(self.model_dir, str(self.exp.exp_name)):
                    if old != path and old.endswith(".pt"):
                        os.remove(old)
        self._barrier()
        return path

    def resume_from_checkpoint(self, path: Optional[str] = None) -> bool:
        """Load ``path``, or the latest checkpoint of this experiment under
        model_dir (the port's ``.pt`` or the JAX package's stream ``.ckpt``)."""
        if path is None:
            found = ckpt.list_checkpoints(self.model_dir, str(self.exp.exp_name))
            if not found:
                return False
            path = found[-1]
        self.load_state_dict(ckpt.load(path))
        print(f"[resume] {path} at iteration {self.it}", flush=True)
        return True

    # ------------------------------------------------------------------ step

    def _inputs(self, audio: np.ndarray, fs: np.ndarray, draws: Optional[List[Dict]] = None):
        """The step's device inputs from host arrays ``audio`` [n_accum, B,
        T] and ``fs`` [n_accum, B], in the eager order: each micro-batch goes
        to the device, is resampled where its rows are at another rate and
        cropped to the model length, then draws its augmentations, sigma
        and noise from ``self.gen`` (each given in ``draws[i]`` is taken
        instead). Returns (x [n_accum, B, L], {name: [n_accum, ...]})."""
        xs, ds = [], []
        for i in range(audio.shape[0]):
            given = {k: torch.tensor(v, device=self.device)
                     for k, v in (draws[i] if draws else {}).items()}
            x = torch.from_numpy(np.ascontiguousarray(audio[i], np.float32)).to(self.device)
            if x.shape[-1] != self.audio_len:
                # native-rate segments: resample on the device, crop to the model length
                x = tutils.resample_batch(x, fs[i], self.target_fs)[..., :self.audio_len]
            B = x.shape[0]
            d = tutils.augment_draws(B, self.aug_cfg, self.gen, self.device,
                                     sign=given.get("sign"), gain_db=given.get("gain_db"))
            sigma = given.get("sigma")
            if sigma is None:
                sigma = edm.sample_ptrain_safe(self.p, B, self.gen, self.device)
            noise = given.get("noise")
            if noise is None:
                noise = edm.sample_prior(self.p, tuple(x.shape), sigma.reshape(-1, 1), self.gen,
                                         self.device)
            xs.append(x)
            ds.append({**d, "sigma": sigma, "noise": noise})
        return torch.stack(xs), {k: torch.stack([d[k] for d in ds]) for k in ds[0]}

    def _backward(self, x: torch.Tensor, draws: Dict[str, torch.Tensor], model):
        """Every micro-batch's forward and backward through ``model`` (the
        bare module or its wrapper); the gradients add up in the parameters'
        ``.grad``. Returns (each micro-batch's loss, the per-sample losses,
        the sigmas)."""
        self.net.zero_grad(set_to_none=True)
        losses, per_sample, sigmas = [], [], []
        n_micro = x.shape[0]
        for i in range(n_micro):
            xi = tutils.augment(x[i], self.aug_cfg, sign=draws.get("sign", [None] * n_micro)[i],
                                gain_db=draws.get("gain_db", [None] * n_micro)[i])
            # DDP averages the gradients over the ranks in the last backward
            sync = (contextlib.nullcontext() if i == n_micro - 1 or model is self.net
                    else model.no_sync())
            with sync:
                err2, sigma = edm.loss_fn(self.p, model, xi, None, self.error_filter,
                                          sigma=draws["sigma"][i], noise=draws["noise"][i])
                ps = err2.reshape(err2.shape[0], -1).mean(-1)
                loss = ps.mean()
                loss.backward()
            losses.append(loss.detach())
            per_sample.append(ps.detach())
            sigmas.append(sigma.detach())
        return losses, torch.cat(per_sample), torch.cat(sigmas)

    def _loss_and_grads(self, x: torch.Tensor, draws: Dict[str, torch.Tensor]):
        """Loss and gradients on the device inputs of ``_inputs``."""
        losses, per_sample, sigmas = self._backward(x, draws, self.model)
        if self.fsdp and self._whole:
            # FSDP averages its shards' gradients; the whole ones are averaged here
            whole = [p.grad for p in self._whole]
            flat = torch.cat([g.reshape(-1) for g in whole])
            pmesh.all_reduce(flat, group=self.mesh.get_group())
            flat /= self.n_dp
            torch._foreach_copy_(whole, [f.view_as(g) for f, g in
                                         zip(flat.split([g.numel() for g in whole]), whole)])
        grads = [self._local(p.grad) if p.grad is not None else torch.zeros_like(q)
                 for p, q in zip(self.net.parameters(), self.params)]
        n = len(losses)
        if n > 1:
            torch._foreach_div_(grads, float(n))
        return sum(losses[1:], losses[0]) / n, per_sample, sigmas, grads

    def loss_and_grads(self, audio: np.ndarray, fs: np.ndarray,
                       draws: Optional[List[Dict]] = None):
        """Loss and gradients of one iteration: ``audio`` [n_accum, B, T],
        ``fs`` [n_accum, B] host arrays; ``draws`` optionally gives each
        micro-batch's ``sign`` [B, 1], ``sigma`` [B] and sigma-scaled
        ``noise`` [B, audio_len]. Returns (loss, per-sample loss, sigma,
        gradients averaged over the micro-batches, and over the ranks under a
        process group; this rank's pieces under FSDP)."""
        return self._loss_and_grads(*self._inputs(audio, fs, draws))

    def _ema_keep(self) -> np.float32:
        """1 - the EMA rate of the next step, in f32 as the JAX step: with
        rampup, rate = min(ema_rate, (1 + t) / (10 + t)), t = (it + 1) batch."""
        tb = (np.float32(self.it) + np.float32(1.0)) * np.float32(self.batch)
        rate = np.float32(self.ema_rate)
        if self.ema_rampup is not None:
            rate = min(rate, (np.float32(1.0) + tb) / (np.float32(10.0) + tb))
        return np.float32(1.0) - rate

    def _stats(self, loss, per_sample, sigma) -> List[torch.Tensor]:
        """[loss / n_dp, the sigma-binned loss moments, the loss moments] of
        this rank's rows: summed over the ranks, the global batch's."""
        return [loss / self.n_dp, tstats.sigma_binned_moments(per_sample, sigma, self._edges),
                tstats.moments(per_sample)]

    @torch.no_grad()
    def apply_grads(self, loss, per_sample, sigma, grads, ema_keep: torch.Tensor) -> Dict:
        """Clip, Adam, LR ramp, guardrails and EMA (``ema_keep``: the 0-dim
        1 - rate); returns the step's metrics (fresh device tensors: nothing
        here waits for the device or reads a number on the host)."""
        stats = self._stats(loss, per_sample, sigma)
        if self.mesh is not None:
            # the global batch's loss and statistics
            stats = tstats.sum_over_ranks(stats, self.mesh.get_group())
        return self._update(grads, ema_keep, *stats)

    @torch.no_grad()
    def _update(self, grads, ema_keep: torch.Tensor, loss, bins, moments) -> Dict:
        """``apply_grads`` on the loss statistics summed over the ranks."""
        norms = torch._foreach_norm(grads)
        if self.fsdp:
            # shards: all-reduce the squares; whole tensors counted once
            sq = torch.stack(norms) ** 2
            sq = torch.where(self.sharded | self.lead, sq, torch.zeros_like(sq))
            pmesh.all_reduce(sq, group=self.mesh.get_group())
            norms = list(sq.sqrt().unbind())
        gnorm = torch.linalg.vector_norm(torch.stack(norms))
        g = grads
        if self.use_clip:
            scale = torch.where(gnorm < self.max_norm, torch.ones_like(gnorm),
                                self.max_norm / gnorm)
            g = torch._foreach_mul(grads, scale)
        # Adam (optax scale_by_adam)
        count_inc = self.count + 1
        mu = torch._foreach_mul(self.mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        nu = torch._foreach_mul(self.nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        t = count_inc.float()
        bc1 = 1.0 - torch.pow(self._b1t, t)
        bc2 = 1.0 - torch.pow(self._b2t, t)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        del den
        # LR ramp on the count before the increment: the first step has lr 0
        lr = self.base_lr * torch.clamp(self.count.float() / self.rampup, max=1.0)
        torch._foreach_mul_(upd, -lr)
        new_p = torch._foreach_add(self.params, upd)
        del upd

        finite = torch.isfinite(gnorm)
        ok = finite
        if self.skip_gnorm > 0:
            ok = ok & (gnorm < self.skip_gnorm)
        warm = self.gnorm_ema > 0.0
        if self.skip_factor > 0:
            ok = ok & (~warm | (gnorm < self.skip_factor * self.gnorm_ema))
        # the state tensors are written in place: a captured step replays
        # into the same addresses
        if self.skip_gnorm > 0 or self.skip_factor > 0:
            # a skipped step keeps the parameters, both moments and the count
            for dst, new in zip(self.params + self.mu + self.nu, new_p + mu + nu):
                dst.copy_(torch.where(ok, new, dst))
            self.count.copy_(torch.where(ok, count_inc, self.count))
            skipped = (~ok).float()
            self.applied += ok.long()
        else:
            torch._foreach_copy_(self.params + self.mu + self.nu, new_p + mu + nu)
            self.count.copy_(count_inc)
            skipped = torch.zeros((), device=self.device)
            self.applied += 1
        del new_p, mu, nu
        g_obs = torch.where(finite, gnorm, self.gnorm_ema)
        if self.skip_factor > 0:
            cap = self.skip_factor * self.gnorm_ema
            g_obs = torch.where(warm & (g_obs > cap), cap, g_obs)
        self.gnorm_ema.copy_(torch.where(warm, 0.98 * self.gnorm_ema + 0.02 * g_obs, g_obs))

        # EMA with rampup, the rate from the host
        d = torch._foreach_sub(self.params, self.ema)
        torch._foreach_mul_(d, ema_keep)
        torch._foreach_add_(self.ema, d)
        del d

        sq = {k: torch.zeros((), device=self.device) for k in self.groups}
        for n, v in zip(self.names, norms):
            k = n.split(".")[0]
            sq[k] = sq[k] + v * v
        return {"loss": loss, "grad_norm": gnorm, "gnorm_ema": self.gnorm_ema.clone(),
                "skipped": skipped, "sigma_bins": bins, "loss_moments": moments,
                "grad_norms_by_module": {k: v.sqrt() for k, v in sq.items()}}

    def _step(self, x: torch.Tensor, draws: Dict[str, torch.Tensor],
              ema_keep: torch.Tensor) -> Dict:
        """One iteration on device tensors: what a step program runs."""
        return self.apply_grads(*self._loss_and_grads(x, draws), ema_keep)

    # A dp step (DDP's) as two functions around its one collective: a step
    # program captures each as a graph and all-reduces between them.

    def _dp_head(self, x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Every micro-batch's forward and backward on the bare module (no
        collective, as under DDP's ``no_sync``); returns one flat f32
        buffer of this rank's gradients scaled by 1 / n_dp (as DDP scales
        them into its buckets) and its loss statistics (``_stats``): summed
        over the ranks, the DDP step's averaged gradients and the global
        batch's statistics."""
        losses, per_sample, sigmas = self._backward(x, draws, self.net)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.net.parameters()]
        stats = self._stats(sum(losses[1:], losses[0]) / len(losses), per_sample, sigmas)
        return torch.cat([g.reshape(-1) * (1.0 / self.n_dp) for g in grads]
                         + [t.reshape(-1) for t in stats])

    def _dp_reduce(self, flat: torch.Tensor) -> None:
        """The dp step's all-reduce of ``_dp_head``'s buffer, in place."""
        pmesh.all_reduce(flat, group=self.mesh.get_group())

    def _dp_tail(self, flat: torch.Tensor, ema_keep: torch.Tensor) -> Dict:
        """``apply_grads`` on views of the all-reduced buffer, the
        gradients divided by the micro-batch count."""
        nb = self._edges.numel() - 1
        *gs, loss, bins, moments = flat.split([q.numel() for q in self.params] + [1, 3 * nb, 3])
        grads = [g.view_as(q) for g, q in zip(gs, self.params)]
        if self.n_accum > 1:
            torch._foreach_div_(grads, float(self.n_accum))
        return self._update(grads, ema_keep, loss.reshape(()), bins.view(nb, 3), moments)

    def get_batch(self):
        """Next host batch: (audio [n_accum B, T] f32, fs [n_accum B])."""
        audio, fs = next(self.dset)
        return np.asarray(audio, np.float32), np.asarray(fs, np.int64)

    # ------------------------------------------------------------ programs

    def programs_enabled(self) -> bool:
        """Whether steps run as programs: the JAX package compiles its step
        under any mesh; here as far as a capture can hold the step's
        collectives. With no process group, one graph; dp without FSDP (a
        DDP step), two graphs around its all-reduce, which runs eagerly
        between them, under any backend; FSDP2, one graph holding its
        all-gathers and reduce-scatters where the group's collectives can
        be captured (NCCL), eager over gloo; a network whose forward
        communicates (tp, cp), eager."""
        if pmesh.communicates(self.net):
            return False
        return not self.fsdp or pmesh.captures_collectives(self.mesh.get_group())

    def _state(self) -> List[torch.Tensor]:
        return [*self.params, *self.mu, *self.nu, *self.ema, self.count, self.gnorm_ema,
                self.applied]

    def _state_key(self) -> tuple:
        """``tensors_key`` of every state tensor and buffer."""
        return tensors_key(itertools.chain(self._state(), self.net.buffers()))

    def _snapshot(self):
        """A copy of the state tensors; returns the function that writes it
        back in place (once). Restoring a state the step programs were built
        over keeps them: it is not a load."""
        saved = [t.detach().clone() for t in self._state()]
        current = self._state_key() == self._state_seen

        def restore():
            with torch.no_grad():
                torch._foreach_copy_(self._state(), saved)
            saved.clear()
            if current:
                self._state_seen = self._state_key()

        return restore

    def release_step_programs(self) -> None:
        """Drop every step program (and its graph pool)."""
        self._step_programs.clear()
        self._state_seen = None

    def _step_program(self, x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> StepProgram:
        """The program for these inputs' shapes and dtypes over the current
        state, built on a miss (on CUDA its warm-up's update is undone)."""
        if self._state_key() != self._state_seen:
            self.release_step_programs()
        buffers = specs({"x": x, **draws})
        key = (tuple(sorted((k, s, str(d)) for k, (s, d) in buffers.items())),
               fa.norm_adaln_gelu, capture_flags(self.net))
        prog = self._step_programs.get(key)
        if prog is None:
            # on the card the build's warm-up trains one step: undone after
            restore = self._snapshot() if self.device.type == "cuda" else None
            # the program holds the trainer weakly: dropping the trainer frees
            # the program and its graph pool without a garbage collection
            trainer = weakref.ref(self)

            def call(name):
                return lambda *a: getattr(trainer(), name)(*a)

            if self.mesh is not None and not self.fsdp:   # dp: split at the all-reduce
                step, hook = (call("_dp_head"), call("_dp_tail")), call("_dp_reduce")
            else:
                step, hook = call("_step"), None
            prog = self._step_programs[key] = StepProgram(step, buffers, self.device,
                                                          restore=restore, hook=hook)
            self.step_programs_built += 1
        self._state_seen = self._state_key()
        return prog

    def compile_step(self, audio, fs) -> Optional[StepProgram]:
        """Build the step program that ``train_step`` runs for this host
        batch's shapes (capture it, on CUDA), without training: the state,
        ``it`` and the random stream come out as they went in. Under a
        process group every rank calls it at the same point: a capture's
        collectives pair up across ranks. Returns it (None where steps run
        eagerly, ``programs_enabled``)."""
        if self.ema is None:
            raise RuntimeError("compile_step needs the trainer's state: call init_state() or "
                               "resume first")
        if not self.programs_enabled():
            return None
        rng, it = self.gen.get_state(), self.it
        try:
            x, d = self._inputs(*self._split(audio, fs))
            return self._step_program(x, d)
        finally:
            self.gen.set_state(rng)
            self.it = it

    # ------------------------------------------------------------------ step

    def _split(self, audio, fs):
        audio = np.asarray(audio, np.float32)
        return (audio.reshape(self.n_accum, -1, audio.shape[-1]),
                np.asarray(fs).reshape(self.n_accum, -1))

    def train_step(self, audio, fs, draws: Optional[List[Dict]] = None) -> Dict:
        """One iteration on a host batch of n_accum x B rows (this rank's
        rows under a process group), split into n_accum micro-batches in
        order: through the step program, or eagerly where programs are off
        (``programs_enabled``)."""
        return self._train_step(audio, fs, draws, self.programs_enabled())

    def _train_step(self, audio, fs, draws, program: bool) -> Dict:
        x, d = self._inputs(*self._split(audio, fs), draws)
        keep = self._ema_keep()
        if program:
            m = self._step_program(x, d).run(x, d, keep)
            self._state_seen = self._state_key()   # an eager CPU run moved the versions
        else:
            m = self._step(x, d, torch.tensor(keep, device=self.device))
        self.it += 1
        return m

    # --------------------------------------------------------------- logging

    def easy_logging(self, metrics) -> Dict[str, float]:
        """Scalars and per-sigma-bin statistics of one log interval (read,
        plotted every tenth interval, then flushed)."""
        out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "grad_norm_ema": float(metrics["gnorm_ema"])}
        for k, v in metrics["grad_norms_by_module"].items():
            out[f"grads/{k}"] = float(v)
        self.collector.update("loss", metrics["loss_moments"].cpu().numpy())
        self.collector.update_binned("loss_by_sigma", metrics["sigma_bins"].cpu().numpy())
        out["loss_mean_since_flush"] = float(np.mean(self.collector.mean("loss")))
        self.wandb.log(out, step=self.it)
        self._plot_count += 1
        if self._plot_count % 10 == 0:
            self.plot(self.bin_edges, self.collector.mean("loss_by_sigma"),
                      self.collector.std("loss_by_sigma"),
                      os.path.join(self.model_dir, "loss_by_sigma.png"))
        self.collector.flush()
        return out

    def heavy_logging(self) -> None:
        """Demo samples with the EMA weights through the tester, on rank 0:
        ``model_dir/heavy_logging/it_N/uncond_i.wav`` and a spectrogram
        ``.png`` beside each. A failing demo is skipped with its traceback
        (demos must not stop training); after two failures in a row the
        demos stay off for this process. Every rank calls it: under FSDP
        the ranks gather the EMA when rank 0 asks for a demo."""
        want = self.tester is not None and self._demo_failures < 2
        ema = self.ema
        if self.fsdp:
            flag = torch.tensor(float(want), device=self.device)
            dist.broadcast(flag, src=0, group=self.mesh.get_group())
            want = bool(flag > 0)
            ema = self._full(self.ema) if want else None
        if not (want and self.lead):
            return
        try:
            x = self.tester.sample_unconditional_ema(dict(zip(self.names, ema)))
            d = os.path.join(self.model_dir, "heavy_logging", f"it_{self.it}")
            clips = {}
            for i, xi in enumerate(x):
                fp = logu.write_audio_file(xi, self.target_fs, f"uncond_{i}", d)
                logu.plot_spectrogram_from_raw_audio(xi, self.target_fs, fp + ".png")
                clips[f"demo/uncond_{i}"] = (xi, self.target_fs)
            self._log_wandb_audio(clips, self.it)
            self._demo_failures = 0
        except Exception:  # the boundary: a demo must never stop training
            print(f"[heavy_logging] demo at iteration {self.it} skipped:", flush=True)
            traceback.print_exc()
            self._demo_failures += 1
            if self._demo_failures >= 2:
                print("[heavy_logging] 2 consecutive failures: demos off for the rest of "
                      "this process", flush=True)

    def _log_wandb_audio(self, named_clips, it: int) -> None:
        """Demo clips ``{name: (audio, fs)}`` to the wandb run; nothing
        without one. A failed upload is printed, never raised."""
        if self.wandb._run is None or not named_clips:
            return
        try:
            import wandb
            self.wandb.log({k: wandb.Audio(np.asarray(a), sample_rate=fs)
                            for k, (a, fs) in named_clips.items()}, step=it)
        except Exception as e:  # logging must never stop training
            print(f"[wandb] demo audio not logged: {e!r}", flush=True)

    def _upload_profile_artifact(self) -> None:
        """The profiler's trace directory as a wandb artifact (the reference
        uploads its torch-profiler trace the same way); nothing without a
        run. A failed upload is printed, never raised."""
        if self.wandb._run is None:
            return
        try:
            import wandb
            art = wandb.Artifact(f"profile-{self.exp.get('exp_name', 'run')}", type="profile")
            art.add_dir(self.profile_dir)
            self.wandb._run.log_artifact(art)
            print(f"[profile] trace uploaded as a wandb artifact ({self.profile_dir})",
                  flush=True)
        except Exception as e:  # logging must never stop training
            print(f"[profile] artifact upload skipped: {e!r}", flush=True)

    # ------------------------------------------------------------------ loop

    @staticmethod
    def _pin_mmap_threshold():
        """Pin glibc's mmap threshold at 128 KiB, so batch-sized host buffers
        always come from mmap and go back to the OS when freed (glibc's
        dynamic raise let them pile up in the heap in long JAX runs)."""
        try:
            import ctypes
            ctypes.CDLL("libc.so.6").mallopt(-3, 128 * 1024)  # M_MMAP_THRESHOLD
        except (OSError, AttributeError):
            pass  # not glibc

    @staticmethod
    def _trim_host_heap():
        """Collect reference cycles, then return freed heap pages to the OS."""
        import gc
        gc.collect()
        try:
            import ctypes
            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except (OSError, AttributeError):
            pass  # not glibc

    def _maybe_recycle_process(self, it: int) -> None:
        """Exit 0 right after a checkpoint when host RSS exceeds
        ``exp.max_host_rss_gb`` (0 = off): a supervisor relaunch resumes from
        that checkpoint in a fresh process, before the OS kills this one."""
        cap_gb = float(self.exp.get("max_host_rss_gb", 0) or 0)
        if cap_gb <= 0:
            return
        rss_gb = 0.0
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        rss_gb = int(line.split()[1]) / 1024 ** 2
                        break
        except OSError:
            return
        over = rss_gb > cap_gb
        if self.mesh is not None:   # every rank recycles, or none
            flag = torch.tensor(float(over), device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.mesh.get_group())
            over = bool(flag > 0)
        if over:
            print(f"[trainer] host RSS {rss_gb:.1f} GB > exp.max_host_rss_gb={cap_gb:.0f}: "
                  f"recycling the process after the it-{it} checkpoint (supervisor resumes)",
                  flush=True)
            sys.stdout.flush()
            os._exit(0)

    def _start_stall_guard(self):
        """Daemon thread: exit(3) when the loop makes no progress for
        stall_timeout_s. Returns the heartbeat cell the loop bumps, or None
        when disabled; ``self._stall_stop.set()`` retires the thread."""
        if self.stall_timeout_s <= 0:
            return None
        import threading
        beat = [time.time()]
        stop = threading.Event()
        self._stall_stop = stop
        _exit = os._exit
        timeout = self.stall_timeout_s

        def _guard():
            while not stop.wait(min(30.0, timeout / 4)):
                idle = time.time() - beat[0]
                if idle > timeout:
                    print(f"[trainer] STALL: no loop progress in {idle:.0f}s "
                          f"(> stall_timeout_s={timeout:.0f}); exiting so a relaunch "
                          "resumes from the latest checkpoint", flush=True)
                    sys.stdout.flush()
                    _exit(3)

        threading.Thread(target=_guard, daemon=True, name="stall-guard").start()
        return beat

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def training_loop(self) -> int:
        if self.ema is None:
            resumed = False
            if bool(self.exp.get("resume", False)):
                resumed = self.resume_from_checkpoint(self.exp.get("resume_checkpoint", None)
                                                      or None)
            if not resumed:
                self.init_state()
        it = self.it
        t0 = time.time()
        beat = self._start_stall_guard()
        last_applied = int(self.applied)
        last_logged_it = it
        prof = None
        while it < self.total_its:
            if self.profile_enabled and it == self.profile_start:
                prof = self._profiler()
                prof.start()
            audio, fs = self.get_batch()
            metrics = self.train_step(audio, fs)
            it = self.it
            if prof is not None and it == self.profile_start + self.profile_its:
                prof.stop()
                os.makedirs(self.profile_dir, exist_ok=True)
                trace = os.path.join(self.profile_dir, f"trace_it{it}.json")
                prof.export_chrome_trace(trace)
                print(f"[profile] {trace}", flush=True)
                prof = None
                self._upload_profile_artifact()
            if self.lead and (it % self.log_interval == 0 or it == 1):
                scalars = self.easy_logging(metrics)
                dt = time.time() - t0
                applied = int(self.applied)
                d_it = max(it - last_logged_it, 1)
                skip_pct = 100.0 * (1.0 - (applied - last_applied) / d_it)
                last_applied, last_logged_it = applied, it
                extra = f"  skip {skip_pct:.0f}%" if skip_pct > 0.5 else ""
                # the dominant per-module gradient norm locates an exploding module
                mods = {k[6:]: v for k, v in scalars.items() if k.startswith("grads/")}
                if mods:
                    top = max(mods, key=mods.get)
                    extra += f"  top {top}:{mods[top]:.2e}"
                print(f"it {it}  loss {scalars['loss']:.5f}  gnorm {scalars['grad_norm']:.3f}"
                      f"{extra}  {dt:.2f}s", flush=True)
                if skip_pct >= 50.0:
                    print(f"[trainer] WARNING: guardrail skipped {skip_pct:.0f}% of the last "
                          f"{d_it} steps (gnorm_ema {scalars['grad_norm_ema']:.3f}): training "
                          "is largely frozen; raise exp.skip_grad_norm or switch to the "
                          "relative exp.skip_grad_factor", flush=True)
                t0 = time.time()
                self._trim_host_heap()
            saved = self.save_model and it % self.save_interval == 0
            if saved:
                self.save_checkpoint()
                self._trim_host_heap()
            if it % self.heavy_log_interval == 0:
                self.heavy_logging()
            if saved:   # after the demo: a recycle at a shared interval must not eat it
                self._maybe_recycle_process(it)
            if beat is not None:
                beat[0] = time.time()
        if beat is not None:
            self._stall_stop.set()  # horizon reached: retire the guard
        self._barrier()
        return it
