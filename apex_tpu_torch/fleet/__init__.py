"""apex_tpu_torch.fleet: multi-replica serving above the continuous
batcher, the counterpart of ``apex_tpu/fleet``.

N :class:`~apex_tpu_torch.serving.serve.ContinuousBatcher` replicas share
ONE set of ``decode_fns`` step functions (on the card each replica keeps
its own CUDA graphs, and a warmed fleet captures nothing new) behind one
router:

- :mod:`~apex_tpu_torch.fleet.router`: :class:`FleetRouter` and its
  declarative :class:`FleetPolicy`: SLO classes with priority queueing
  and admission control, prefix-affinity routing on the prefix cache's
  page hashes, least-loaded and round-robin routing, health and
  quarantine, deadlines, hedging, the brownout ladder, and disaggregated
  prefill / decode roles that move KV pages between replicas;
- :mod:`~apex_tpu_torch.fleet.failover`: the replayable
  :class:`RequestLog` and :func:`resume_request` (zero-loss failover,
  token-identical continuations);
- :mod:`~apex_tpu_torch.fleet.journal`: the CRC-checked write-ahead
  :class:`RequestJournal` and :func:`recover_journal`, byte-compatible
  with the JAX package's, for a restart after the process died.

``apex_tpu_torch.tools.load_gen`` makes the deterministic traces and
replays them through a router.
"""

_LAZY_ATTRS = {
    "router": "apex_tpu_torch.fleet.router",
    "failover": "apex_tpu_torch.fleet.failover",
    "journal": "apex_tpu_torch.fleet.journal",
    "SLOClass": "apex_tpu_torch.fleet.router",
    "FleetPolicy": "apex_tpu_torch.fleet.router",
    "BrownoutPolicy": "apex_tpu_torch.fleet.router",
    "Replica": "apex_tpu_torch.fleet.router",
    "FleetRouter": "apex_tpu_torch.fleet.router",
    "FleetCompletion": "apex_tpu_torch.fleet.router",
    "INTERACTIVE": "apex_tpu_torch.fleet.router",
    "BATCH": "apex_tpu_torch.fleet.router",
    "LogEntry": "apex_tpu_torch.fleet.failover",
    "RequestLog": "apex_tpu_torch.fleet.failover",
    "resume_request": "apex_tpu_torch.fleet.failover",
    "RequestJournal": "apex_tpu_torch.fleet.journal",
    "JournalRecovery": "apex_tpu_torch.fleet.journal",
    "recover_journal": "apex_tpu_torch.fleet.journal",
}

__all__ = sorted(_LAZY_ATTRS)


def __getattr__(name):
    if name in _LAZY_ATTRS:
        import importlib

        mod = importlib.import_module(_LAZY_ATTRS[name])
        val = (mod if name in ("router", "failover", "journal")
               else getattr(mod, name))
        globals()[name] = val
        return val
    raise AttributeError(
        f"module 'apex_tpu_torch.fleet' has no attribute {name!r}"
    )
