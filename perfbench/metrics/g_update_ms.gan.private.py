"""g_update_ms.gan.private: g_update_ms.gan (`metrics/g_update_ms.gan.py`)
in the cells of the privacy deployment, whose rounds have an end-to-end
metric of their own (`round_s.private`)."""
from perfbench.common import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "g_update_ms.gan.py").read
