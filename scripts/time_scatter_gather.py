#!/usr/bin/env python3
"""Times of the ordered scatter-add (K4) and the row gather (K5) of the
``houv_tpu_torch`` in the working directory, and the end-to-end rates
around them, all taken by this repository's ``chip_smoke.py``, so that an
older checkout can be timed beside this one on one card, in turns:

    (cd <old checkout> && python3 <this repo>/scripts/time_scatter_gather.py)
    python3 scripts/time_scatter_gather.py

- K4 and K5 at the shapes of PERF.md's kernel table (``_time_scatter``,
  ``_time_gather_rows``: device time, plain version, library yardstick);
- train steps/s of 10 steps on one repeated batch of cfgs/vrcnet.yaml,
  cfgs/pcn.yaml and cfgs/ecg.yaml (``_repeated_batch``; 4, 2 and 2 K4
  launches a step);
- pairs/s of ``test_main`` on cfgs/houv_fast.yaml over 100 pairs
  (``run_sweep``; no K4 or K5: the host's speed on this machine).

Only the package comes from the working directory. Prints one JSON line
after chip_smoke's own; needs CUDA and builds the checkout's kernels at
first use.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (imports no package of the port itself)

sys.path.insert(0, os.getcwd())         # the checkout's houv_tpu_torch


def main() -> int:
    if not torch.cuda.is_available():
        print("time_scatter_gather: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    out = {"checkout": os.getcwd(), "card": torch.cuda.get_device_name(0),
           "scatter_add": [chip_smoke._time_scatter(b, 2048, m, gen)
                           for b, m in ((64, 3072), (1024, 2048))],
           "gather_rows": chip_smoke._time_gather_rows(gen)}
    with tempfile.TemporaryDirectory() as tmp:
        out["train_steps_per_s"] = {
            model: chip_smoke._repeated_batch(tmp, 10, False,
                                              model)["steps_per_s"]
            for model in ("vrcnet", "pcn", "ecg")}
        out["houv_fast_pairs_per_s"] = chip_smoke.run_sweep(
            "houv_fast.yaml", 100, Path(tmp))["pairs_per_s"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
