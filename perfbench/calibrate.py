#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, in one
process (no measured window):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--control-seeds 4 5 6] [--fault half_batch --fault-seeds 7 8 9]

For each of ``--seeds``: the program's first ``check_steps`` steps at the
cell's own size against the plain reference (the lower reading).  For each
of ``--control-seeds``: the reference computed in the precision below the
configuration's (TF32 for fp32, fp8 for bf16) against the reference (the
control, which must read high).  For each of ``--fault-seeds``: the
program with ``--fault`` planted (``perfbench/faults.py``) against the
reference.  One JSON line a reading; the benchmark's own runs do not run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == _HERE:
    sys.path.pop(0)
sys.path[:0] = [str(_HERE.parent), str(_HERE.parent / "src")]


def control_records(spec, seed, dev):
    """The control's record (the reference one precision below the
    configuration's) and the reference's, from one run's inputs."""
    from perfbench import common
    sess = common.driver(spec["config"]["driver"]).Session(
        spec, seed, dev, program=False)
    ref = sess.reference_record(keep=True)
    low = sess.reference_record(lowp=True, other=ref.pop("kept", None))
    return low, ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from perfbench import common, faults
    common.env_for_checkout()
    import torch

    spec = common.resolve_cell(args.workload)
    drv = common.driver(spec["config"]["driver"])
    dev = torch.device(args.device)

    def emit(kind, seed, prog, ref, t0):
        vals = common.readings(prog, ref)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "readings": vals,
                          "detail": common.detail(prog, ref),
                          "dropped": ref.get("dropped"),
                          "load_max": ref.get("load_max"),
                          "seconds": time.perf_counter() - t0}), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        sess = drv.Session(spec, seed, dev)
        sess.release()
        emit("program", seed, sess.record, sess.reference_record(), t0)
        del sess
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        low, ref = control_records(spec, seed, dev)
        emit("control", seed, low, ref, t0)
        del low, ref
    if args.fault_seeds:
        undo = faults.install(spec["config"]["driver"], args.fault)
        try:
            for seed in args.fault_seeds:
                t0 = time.perf_counter()
                sess = drv.Session(spec, seed, dev)
                sess.release()
                emit(f"fault:{args.fault}", seed, sess.record,
                     sess.reference_record(), t0)
                del sess
        finally:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
