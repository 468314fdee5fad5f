"""host_syncs.gan.private: host_syncs.gan (`metrics/host_syncs.gan.py`) in
the cells of the privacy deployment, whose rounds have an end-to-end metric
of their own (`round_s.private`)."""
from perfbench.common import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "host_syncs.gan.py").read
