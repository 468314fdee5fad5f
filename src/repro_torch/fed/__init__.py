"""Event-driven federation runtime (port of ``repro/fed``).

  transport   links, byte accounting, the uplink codecs
  events      event queue + client availability traces
  policies    sync barrier FedAvg (host or fedavg CUDA kernel)
  programs    the client-side local round as data (plain, DP-SGD, split),
              run as a per-client loop
  engine      discrete-event round engine (sync scheduling)
"""
