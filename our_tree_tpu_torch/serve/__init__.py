"""The online CTR serve path of the port (``our_tree_tpu.serve``'s ctr mode).

Many small requests from many tenants coalesce into fixed-shape multi-key
dispatches of the ``ctr_mk`` kernel:

* ``queue``    - admission control and backpressure (depth, tenant and
  priority shedding, per-request deadlines);
* ``batcher``  - the rung-packer: key groups packed up to K slots per batch,
  padded to a power-of-two ladder rung;
* ``keycache`` - per-tenant LRU of expanded schedules and the memo of
  stacked (K, 4*(nr+1)) schedules;
* ``dispatch`` - one worker thread per lane with its watchdog kill path;
* ``lanes``    - the fault domains (health states, retry, quarantine, canary
  probation, bit-exact failover) and the one device seam;
* ``server``   - the dispatch loop, warmup and graceful drain;
* ``loadgen``, ``bench`` - ``python -m our_tree_tpu_torch.serve.bench``.
"""
