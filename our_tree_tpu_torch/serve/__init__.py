"""The online serve path of the port (``our_tree_tpu.serve``'s modes:
``ctr``, ``gcm``, ``gcm-open``, ``cbc`` and ``rc4``).

Many small requests from many tenants coalesce into fixed-shape multi-key
dispatches, one mode a dispatch: ``ctr_mk`` for ``ctr``, ``ctr_mk`` and then
``ghash_at`` for AES-GCM seal (``gcm``) and open (``gcm-open``), ``cbc_mk``
for CBC decrypt (``cbc``), the torch XOR for ``rc4`` session chunks, whose
keystream the session store refills ahead with ``arc4_prga``:

* ``queue``    - admission control and backpressure (depth, tenant and
  priority shedding, per-request deadlines), the mode vocabulary and the
  error codes (``GCM_MODES``, ``ERR_AUTH`` among them);
* ``batcher``  - the rung-packer: key groups packed up to K slots per batch,
  padded to a power-of-two ladder rung;
* ``keycache`` - per-tenant LRU of expanded schedules and the memo of
  stacked (K, 4*(nr+1)) schedules;
* ``dispatch`` - one worker thread per lane with its watchdog kill path;
* ``lanes``    - the fault domains (health states, retry, quarantine, canary
  probation, bit-exact failover) and the one device seam;
* ``server``   - the dispatch loop, warmup and graceful drain;
* ``session``  - the rc4 session store: host KSA at open, the batched
  keystream prefetch, carry checkpoints for bit-exact failover;
* ``transfer`` - chunked transfers: a payload above the top rung as
  rung-sized riders, reassembled in order, resumable through a ledger;
* ``status``   - the status endpoint (``/metrics``, ``/healthz``,
  ``/incidentz``, ``/profilez``);
* ``wire``     - the framed request/response protocol (JSON header line and
  raw payload);
* ``worker``   - ``python -m our_tree_tpu_torch.serve.worker``: one back-end
  process, a whole Server behind a TCP front end;
* ``loadgen``, ``bench`` - ``python -m our_tree_tpu_torch.serve.bench``.
"""

from .queue import (ERR_AUTH, ERR_BAD_REQUEST, ERR_DEADLINE, ERR_DISPATCH, ERR_SHED,
                    ERR_SHUTDOWN, ERR_TOO_LARGE, ERR_TRANSFER_ABORT, ERR_TRANSFER_MODE, GCM_MODES,
                    MODES, Request, RequestQueue, Response, ServeError)

__all__ = ["ERR_AUTH", "ERR_BAD_REQUEST", "ERR_DEADLINE", "ERR_DISPATCH", "ERR_SHED",
           "ERR_SHUTDOWN", "ERR_TOO_LARGE", "ERR_TRANSFER_ABORT", "ERR_TRANSFER_MODE",
           "GCM_MODES", "MODES", "Request", "RequestQueue", "Response",
           "ServeError"]
