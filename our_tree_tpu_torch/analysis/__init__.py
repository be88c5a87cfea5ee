"""otlint over the port: the repo-invariant static analysis of
``our_tree_tpu_torch/``, a copy of ``our_tree_tpu.analysis`` aimed at the
port's own seams. One CLI (``python -m our_tree_tpu_torch.analysis``), one
baseline (``our_tree_tpu_torch/analysis/baseline.json``, every entry with
its reason), three layers:

* **Layer 1, the AST linter** (``astrules.py``): the reference's rules by
  the same ids, severities and message shapes: child processes only
  through ``resilience.isolate``; the card's barriers, staging and kernel
  wrappers only under a watchdog guard or in a seam; demotions only
  through ``degrade()``; no wall-clock reads outside ``obs/``; trace
  attributes JSON-clean; fault points and metric labels from the port's
  registries; serve dispatch only through ``serve/lanes.py``; backend
  contact in ``route/`` only through ``route/proxy.py``, and no ``torch``
  import there.
* **Layer 2, the graph auditor** (``graph_audit.py``, the counterpart of
  ``jaxpr_audit.py``): traces the plain versions on the CPU into aten
  graphs and walks them with a taint analysis seeded from the key and data
  arguments: a secret-indexed lookup, a value widened to 64 bits from
  taint, a graph whose size grows with the batch.
* **ot-san** (``callgraph.py``, ``sanrules.py``): loop stalls, lock
  discipline and thread ownership over the whole package's call graph.

Findings carry a stable fingerprint, so the baseline suppresses known
findings and the gate (``--baseline ... --fail-on-new``) fails on new ones
only. Layers 1 and ot-san are stdlib only; layer 2 imports torch lazily and
runs on the CPU.
"""

from .findings import Finding  # noqa: F401
