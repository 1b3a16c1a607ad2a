"""Where prefill time goes on the card, for full-width recurrentgemma-2b.

    python3 tools/prefill_profile.py          # needs one CUDA card

Random bf16 weights from seed 0 (prefill time does not depend on their
values), B = 2, S = 4,096, through ``make_prefill_step`` as
``chip_smoke.py`` drives it: for each impl (``pallas``, the flash kernel;
``xla``, the plain chunked attention) one warm-up call, then one call
under ``torch.profiler``: kernel time by name, device busy time against
host wall time.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.train.steps import make_prefill_step  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("recurrentgemma-2b")
    model = build(cfg)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4096),
                                     generator=gen, device="cuda")}
    for impl in ("pallas", "xla"):
        step = make_prefill_step(model, impl=impl)
        step(params, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, batch)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ka = prof.key_averages()
        # kernel rows only: operator rows repeat their kernels' device time
        busy = sum(e.self_device_time_total for e in ka
                   if e.device_type == DeviceType.CUDA) / 1e3
        print(f"prefill impl={impl}, B=2 S=4096, under the profiler: host "
              f"wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms")
        print(ka.table(sort_by="self_device_time_total", row_limit=20,
                       max_name_column_width=70))


if __name__ == "__main__":
    main()
