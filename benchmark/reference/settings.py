"""The reference's settings, read from a configuration file of the benchmark
(never from the program): the sampler's and the trainer's, with the options
the reference does not implement refused."""
from __future__ import annotations

from typing import Tuple


def _edm(dp: dict) -> dict:
    return {"sigma_data": float(dp["sigma_data"]), "sigma_min": float(dp["sigma_min"]),
            "sigma_max": float(dp["sigma_max"]), "rho": float(dp["ro"]),
            "rho_train": float(dp.get("ro_train", dp["ro"])), "Schurn": float(dp["Schurn"]),
            "Snoise": float(dp["Snoise"]), "Stmin": float(dp["Stmin"]), "Stmax": float(dp["Stmax"])}


def sampling(cfg: dict) -> Tuple[dict, dict]:
    """(EDM parameters, sampler settings) of the serving role."""
    t = cfg["serving"]["stated"]["tester"]
    ps, dc = t["posterior_sampling"], t["data_consistency"]
    if ps["norm"] != 2 or not (dc["use"] and dc["type"] == "always" and dc["smooth"]) \
            or t["diff_params"]["same_as_training"]:
        raise ValueError("the reference samples with the L2 guidance norm, a smoothed "
                         "projection every step and the test-time EDM parameters only")
    s = {"T": int(t["T"]), "order": int(t["order"]), "xi": float(ps["xi"]),
         "hann_size": int(dc["hann_size"]), "filter_out_cqt_DC_Nyq": bool(t["filter_out_cqt_DC_Nyq"]),
         "audio_len": int(cfg["exp"]["audio_len"])}
    return _edm(t["diff_params"]), s


def training(cfg: dict, role: str = "training") -> Tuple[dict, dict]:
    """(EDM parameters, trainer settings) of a training role (``training``,
    or one over several ranks such as ``training_dp4``)."""
    st = cfg[role]["stated"]
    e = st["exp"]
    aug = e["augmentations"]
    if int(e["num_accumulation_rounds"]) != 1 or aug["gain"]["use"] or aug["pitch_shift"]["use"] \
            or e["use_cqt_DC_correction"] or st["diff_params"]["aweighting"]["use_aweighting"]:
        raise ValueError("the reference trains one micro-batch with the polarity flip only, "
                         "no loss filter")
    opt = e["optimizer"]
    tr = {"lr": float(e["lr"]), "lr_rampup_it": int(e["lr_rampup_it"]),
          "beta1": float(opt["beta1"]), "beta2": float(opt["beta2"]), "eps": float(opt["eps"]),
          "use_grad_clip": bool(e["use_grad_clip"]), "max_grad_norm": float(e["max_grad_norm"]),
          "skip_grad_norm": float(e["skip_grad_norm"] or 0), "skip_grad_factor": float(e["skip_grad_factor"] or 0),
          "ema_rate": float(e["ema_rate"]), "ema_rampup": e["ema_rampup"] is not None,
          "rev_polarity": bool(aug["rev_polarity"]), "batch": int(e["batch"])}
    return _edm(st["diff_params"]), tr
