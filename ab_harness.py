"""What the A/B timing scripts (`gmm_ab.py`, `spmv_ab.py`,
`flash_bwd_ab.py`, `flash_fwd_ab.py`, `recurrent_prefill_ab.py`) share:
the card's name and power limit, CUDA-event and host-clock timers, and
the loop that measures several checkouts in turns, each in a process of
its own (the checkouts share module names).

A script defines ``child(root) -> dict``, which imports the port from
``root / "src"``, measures and returns its numbers, and ends with
``sys.exit(ab_harness.main(sys.argv, __file__, "<label>", child))``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def device_ms(fn, reps: int, *, warmup: int = 3,
              behind_sleep: bool = False) -> float:
    """Device milliseconds a call of ``fn``: CUDA events around ``reps``
    calls after ``warmup``; with ``behind_sleep``, queued behind a device
    sleep, so the host cannot starve the device."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if behind_sleep:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    """Host milliseconds a call of ``fn``: the wall of enqueuing ``reps``
    calls after a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def compare(script: str, label: str, roots: list[str]) -> int:
    """Runs ``script --child root`` for each root in turn and prints its
    numbers, one line per key (or one line where the child returns flat
    numbers; a value that is not a number, such as a checkout's refusal,
    as it is), then the card's line."""
    for root in roots:
        proc = subprocess.run([sys.executable, script, "--child", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        value = json.loads(proc.stdout.splitlines()[-1])
        rows = (value.items() if all(isinstance(v, dict)
                                     for v in value.values())
                else [(None, value)])
        for key, numbers in rows:
            head = f"{label} [{root}]" + (f" {key}" if key else "")
            print(f"{head}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in numbers.items()))
    print(card_line())
    return 0


def main(argv: list[str], script: str, label: str, child) -> int:
    """A script's entry: ``--child ROOT`` measures one checkout and prints
    its numbers as JSON; otherwise the card's line, then ``compare`` over
    the arguments (this checkout where there are none)."""
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(child(pathlib.Path(argv[2]).resolve())))
        return 0
    print(f"card: {card_line()}")
    return compare(script, label, argv[1:] or ["."])
