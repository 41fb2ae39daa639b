"""The benchmark of ``lancedb_tpu_torch`` (the PyTorch + CUDA package) on
one NVIDIA H100: one command runs one cell once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; each of them is a file of its own under this folder, found
by its name:

- ``configs/<config>.json``: a deployment (schema, scale, index and
  search parameters, guarantees, the limits of the comparison);
- ``traffic/<mix>.json``: the parameters of a traffic mix, and the name
  of the loop that drives it;
- ``loops/<loop>.py``: how a kind of traffic sets the cell up, drives the
  entry point through the window, gathers what the window produced and
  judges it against the reference (``set_up``, ``window``, ``answers``,
  ``judge``; ``control`` for ``control.py``); ``drive.py`` holds what
  the loops share;
- ``e2e_metrics/<metric>.py`` and ``layer_metrics/<metric>.py``: one small
  reader a metric, over the window's record or the traced run's spans,
  counters and device trace (``readers.py`` holds what they share).

``reference/`` holds the plain PyTorch and NumPy reference and the
comparison that decides ``correct``; it imports nothing of the port.
"""
