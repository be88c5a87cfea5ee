"""The routing tier: a consistent-hash router over N serve workers.

Port of ``our_tree_tpu.route``. Lanes are the per-device fault domain; the
router's back ends are the per-process one. A request is a pure function of
(tenant, key, nonce, payload), so a failed or hung back end's request
replays bit-exactly on the next ring node before any rider is answered, as a
lane's batch does.

Modules:

* ``ring``: the consistent-hash ring with virtual nodes. A tenant's key
  digest maps to the back end whose keycache already holds its schedules
  (key affinity); members join and leave with minimal motion, and the
  clockwise successor order is the failover replica sequence. Placement
  and the digest are the JAX package's, key for key.
* ``health``: the lane state machine per back end (healthy, suspect,
  quarantined, probation, released), driven by dispatch outcomes and
  ``/healthz`` gossip; a quarantine is a journal failure row for
  ``backend:<name>``, released by the same ``--unquarantine`` edit as a
  lane's.
* ``proxy``: the ``Router``: placement, ``Budget`` deadlines, bit-exact
  failover before any error, the pinned canary, shed backpressure, the
  connection pool, membership changes and drain, chunked transfers and the
  rc4 session pin. The only module that contacts a back end.
* ``status``: the router's ``/metrics`` (federated over its back ends) and
  ``/healthz`` with the ring's membership view, ``/alertz`` and
  ``/fleetz``.
* ``fleet``: the fleet supervisor (autoscaling, rolling upgrades), the
  replica router server, gossip between router replicas and the failover
  client; ``python -m our_tree_tpu_torch.route.fleet`` is one replica.
* ``bench``: ``python -m our_tree_tpu_torch.route.bench`` spawns N port
  workers (``python -m our_tree_tpu_torch.serve.worker``, on the card
  unless ``--device cpu``), drives the router with the serve load
  generator and gates zero lost, zero steady builds and bit-exact probes.

The router touches no device: no module here imports torch, JAX or
anything of the JAX package, and the router's process never creates a CUDA
context. The workers run the kernels. Wire format: ``serve/wire.py``; error
codes: ``serve.queue``'s ``ERR_*`` set (the router adds none).
"""
