"""mfu.gan_round.private: mfu.gan_round (`metrics/mfu.gan_round.py`) in the cells of the privacy
deployment, whose rounds have an end-to-end metric of their own
(`round_s.private`)."""
from perfbench.common import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "mfu.gan_round.py").read
