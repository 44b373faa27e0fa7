"""DeepGMR's first data-parallel train step on the card, in f32 and in f64,
over several seeds of the batch's poses: the first loss over two gloo
ranks of 16 rows against one process on the global batch of 32
(``cfgs/deepgmr.yaml``), and each f32 loss against one process's f64 loss,
the f32 model's own rounding. It runs ``chip_smoke.py``'s DDP helpers
(``_ddp_inputs``, ``_gloo_rank``, ``_ddp_compare``) with ``DDP_SEED`` set
to each seed in turn, so its readings are those of the smoke's
``parallel_ddp`` record for the ``deepgmr`` run. Run from the repository's
root on a machine with a card:

    python3 scripts/ddp_loss_rounding.py [--seeds 0,1,2,3,4,5]

It prints one JSON object a seed and, last, the largest of each
relative difference over the seeds."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402

READS = ("first_loss_rel", "first_loss_rel_f64", "one_f32_vs_f64_rel",
         "ddp_f32_vs_f64_rel", "first_grad_err_over_max_grad",
         "running_stats_after_step_1_worst_rel")


def main(argv=None) -> int:
    import torch

    from houv_tpu_torch.parallel.distributed import launch

    p = argparse.ArgumentParser(prog="ddp_loss_rounding.py")
    p.add_argument("--seeds", default="0,1,2,3,4,5",
                   help="the batch seeds, comma-separated")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ddp_loss_rounding: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.pop("WORLD_SIZE", None)
    seeds = [int(s) for s in args.seeds.split(",")]
    smoke.DDP_RUNS = (("deepgmr", "deepgmr", 32, 2, {}),)
    ddp, one = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            smoke.DDP_SEED = seed
            d, o = smoke._ddp_inputs(Path(tmp) / f"seed{seed}")
            ddp[f"seed{seed}"], one[f"seed{seed}"] = d["deepgmr"], o["deepgmr"]
        two = launch(smoke._gloo_rank, 2, "cuda", backend="gloo",
                     args=({}, ddp))
    worst = dict.fromkeys(READS, 0.0)
    for run, (raw, _, n_steps) in ddp.items():
        rec = smoke._ddp_compare(run, raw, one[run], two[run], n_steps)
        row = {"seed": int(run[4:]), "losses_one": rec["losses_one"][:1],
               "losses_ddp": rec["losses_ddp"][:1],
               "losses_f64": rec["losses_f64"],
               **{k: rec[k] for k in READS}}
        print(json.dumps(row), flush=True)
        for k in READS:
            worst[k] = max(worst[k], rec[k])
    print(json.dumps({"seeds": seeds, "worst": worst,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
