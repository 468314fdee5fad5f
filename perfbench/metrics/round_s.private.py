"""round_s.private: round_s (`metrics/round_s.py`, the window's wall time
over the rounds completed in it) in the cells of the privacy deployment
(DP-SGD through the executed split), whose rounds the host's dispatch
holds about as long as the device's work: they spread more from process
to process, and have a bound of their own."""
from perfbench.common import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "round_s.py").read
