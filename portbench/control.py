"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below the configuration's
float32 (``reference/lower_precision.py``). It is run through the
harness's own ``run_cell``, with each request answered by the control, so
it is judged by the same numbers and limits as a run's answers; it has to
come out as not correct. A limit is set between what the program's runs
read and what this control reads.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

Run on the card at the cell's own sizes (``--device cpu --height --width``
for a small rehearsal). For each seed it prints one JSON line: the largest
reading of each number, the limits, and ``correct``. The benchmark's own
runs never run this."""
from __future__ import annotations

import argparse
import json
import sys


class Control:
    """The cell's entry with every request answered by the reference one
    precision lower, image by image, on the entry's device."""

    def __init__(self, entry, device):
        self._entry, self._device = entry, device

    def __getattr__(self, name):
        return getattr(self._entry, name)

    def request(self, payload):
        return [self._entry.reference(image, self._device, lower_precision=True)
                for image in payload]


def run_control(workload: str, seed: int, seconds: float, device: str = "cuda", shape=None,
                cell_overrides=None) -> dict:
    """``run.run_cell`` with the control in the program's place."""
    from portbench import run

    return run.run_cell(workload, seed, seconds, False, device=device, shape=shape,
                        cell_overrides=cell_overrides,
                        entry_hook=lambda entry: Control(entry, device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int)
    ap.add_argument("--width", type=int)
    args = ap.parse_args(argv)
    shape = (args.height, args.width) if args.height else None
    for seed in args.seeds:
        r = run_control(args.workload, seed, args.seconds, args.device, shape)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": r["readings"],
                          "limits": r["limits"], "correct": r["correct"],
                          "requests": r["requests"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
