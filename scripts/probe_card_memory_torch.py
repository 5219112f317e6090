#!/usr/bin/env python3
"""Where the card's memory goes when the port builds programs and when
``chip_smoke.py`` phase 7 runs its ranks beside other work.

    python scripts/probe_card_memory_torch.py pool
    python scripts/probe_card_memory_torch.py phase7 [--out DIR]   (DIR: experiments/probe_card_memory)

``pool``: the 22 kHz flagship service (T=4) precompiles its programs (one
and two rows), releases them, precompiles again and is deleted; after each
step this process's allocated and reserved bytes and the card's use.

``phase7``: ``chip_smoke.phase_parallel`` alone (the corpus written, phase
5's requests rebuilt without answers, nothing beside the ranks), with the
card's used memory and this process's reserved memory sampled every 0.5 s
into ``DIR/phase7_memory.json``; prints the peak and a sample every 10 s.

Needs a CUDA device; prints the card's name and power limit first.
"""
import argparse
import gc
import json
import os
import shutil
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def memory(torch, tag):
    free, total = torch.cuda.mem_get_info()
    print(json.dumps({"at": tag, "allocated_gb": torch.cuda.memory_allocated() / 2 ** 30,
                      "reserved_gb": torch.cuda.memory_reserved() / 2 ** 30,
                      "card_used_gb": (total - free) / 2 ** 30}), flush=True)


def pool(torch):
    from aid_tpu_torch.serving import InpaintingService
    memory(torch, "start")
    svc = InpaintingService.from_config(["tester.T=4"])
    memory(torch, "service built")
    svc.precompile()
    memory(torch, "precompiled (two programs)")
    for prog in svc.sampler._programs.values():
        print(json.dumps(prog.report()), flush=True)
    del prog
    svc.sampler.release_programs()
    gc.collect()
    torch.cuda.empty_cache()
    memory(torch, "released, collected, cache emptied")
    svc.precompile()
    memory(torch, "precompiled again")
    del svc
    torch.cuda.empty_cache()
    memory(torch, "service deleted, cache emptied (no collection)")


def phase7(torch, out):
    import numpy as np

    import chip_smoke as cs
    from aid_tpu_torch.ops import fused_adaln as fa
    from aid_tpu_torch.tools.profile_denoiser import gpu_line
    from aid_tpu_torch.utils.config import compose
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(HERE, "experiments", "probe_phase7")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    args = compose()
    cs.write_corpus(np, os.path.join(work, "maestro"), int(args.dset.load_len),
                    int(args.exp.audio_len * args.exp.resample_factor))
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    g25, g1500 = int(0.025 * fs), int(1.5 * fs)
    m = np.ones(L, np.float32)
    m[(L - g1500) // 2:(L - g1500) // 2 + g1500] = 0.0
    req_a = {"audio": cs.music(np, L, fs, 0), "mask": m, "fs": fs}
    n = int(2.5 * L)
    m = np.ones(n, np.float32)
    for c in (0.2, 0.45, 0.7, 0.9):
        s = int(c * n)
        m[s:s + g25] = 0.0
    req_b = {"audio": cs.music(np, n, fs, 1), "mask": m, "fs": fs}
    samples, stop, t0 = [], threading.Event(), time.time()

    def sample():
        while not stop.is_set():
            free, total = torch.cuda.mem_get_info()
            samples.append((round(time.time() - t0, 1), round((total - free) / 2 ** 30, 2),
                            round(torch.cuda.memory_reserved() / 2 ** 30, 2)))
            time.sleep(0.5)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        cs.phase_parallel(torch, fa, np, work, gpu_line(), req_a, req_b,
                          lambda: None, lambda: None)
    finally:
        stop.set()
        th.join()
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "phase7_memory.json"), "w") as f:
            json.dump({"columns": ["s", "card_used_gb", "this_process_reserved_gb"],
                       "samples": samples}, f)
    print(json.dumps({"peak_card_used": max(samples, key=lambda x: x[1])}), flush=True)
    for row in samples[::20]:
        print(row, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("pool", "phase7"))
    ap.add_argument("--out", default=os.path.join("experiments", "probe_card_memory"))
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_card_memory_torch: no CUDA device")
    sys.path.insert(0, HERE)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, ".triton_cache"))
    from aid_tpu_torch.tools.profile_denoiser import gpu_line
    print(f"gpu: {gpu_line()}", flush=True)
    if a.what == "pool":
        pool(torch)
    else:
        phase7(torch, a.out)


if __name__ == "__main__":
    main()
