"""Two ways CUPTI loses a torch.profiler window's kernel records, each
shown on a card by counting the records a window of 40 matrix products
keeps (``chip_smoke._cupti_room`` and its ``TEARDOWN_CUPTI`` setting act
on them).

``python3 cupti_probe.py cache``: a window on a fresh process, two with
PyTorch's caching allocator holding nearly all the card's memory (every
block freed but kept reserved), then one after ``empty_cache``; each
line gives the records kept, the free memory and what the allocator
holds.

``python3 cupti_probe.py teardown``: in two processes, PyTorch's default
(CUPTI torn down and attached again at each window) and
``TEARDOWN_CUPTI=0``, eight windows on a full cache: three, three behind
a 100 ms spin kernel, and two more.
"""
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile, schedule


def dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def window(n=40, lead_ms=0):
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as p:
        x @ x
        torch.cuda.synchronize()
        p.step()
        if lead_ms:
            torch.cuda._sleep(int(lead_ms * 2e6))
            torch.cuda.synchronize()
        for _ in range(n):
            x @ x
        torch.cuda.synchronize()
        p.step()
    return [(e.key[:50], e.count) for e in p.key_averages() if dev_us(e) > 0]


def kept(ks):
    return sum(c for k, c in ks if "sgemm" in k)


def fill_cache():
    blocks = []
    try:
        while True:
            blocks.append(torch.empty(256 * 2**20, dtype=torch.uint8,
                                      device="cuda"))
    except torch.OutOfMemoryError:
        pass
    del blocks


def info(tag):
    ks = window()
    f, _ = torch.cuda.mem_get_info()
    print(tag, (sum(c for _, c in ks), ks), "free_gb", round(f / 2**30, 2),
          "reserved_gb", round(torch.cuda.memory_reserved() / 2**30, 2),
          flush=True)


def cache():
    info("fresh")
    fill_cache()
    info("cache_full")
    info("cache_full_again")
    torch.cuda.empty_cache()
    info("after_empty_cache")


def teardown_leg():
    fill_cache()
    print(os.environ.get("TEARDOWN_CUPTI", "default"), "full cache, no lead:",
          [kept(window()) for _ in range(3)], "100 ms lead:",
          [kept(window(lead_ms=100)) for _ in range(3)], "no lead:",
          [kept(window()) for _ in range(2)], flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("cupti_probe: no CUDA device visible")
    mode = sys.argv[1] if len(sys.argv) > 1 else "cache"
    if mode == "cache":
        cache()
    elif mode == "teardown":
        for env in ({}, {"TEARDOWN_CUPTI": "0"}):
            subprocess.run([sys.executable, __file__, "teardown-leg"],
                           env={**os.environ, **env}, check=True)
    elif mode == "teardown-leg":
        teardown_leg()
    else:
        raise SystemExit("usage: cupti_probe.py [cache|teardown]")
