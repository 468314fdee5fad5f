"""Event-driven federation runtime (port of ``repro/fed``).

  transport   links, byte accounting, the uplink codecs
  events      event queue + client availability traces
  policies    sync barrier FedAvg (host or fedavg CUDA kernel), FedAsync,
              FedBuff
  programs    the client-side local round as data (plain, DP-SGD, split),
              run as a per-client loop or stacked over clients
  aggregate   the compressed-domain server reduce over wire payloads
              (agg_fuse CUDA kernels)
  hierarchy   edge cohorts that pre-reduce before the WAN
  engine      discrete-event round engine (sync, hierarchical, async)
"""
