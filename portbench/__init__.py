"""The benchmark of ``tntorch_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. What a cell
needs is found by name: its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<mix>.json`` (whose ``kind`` names the driver in
``drivers/<kind>.py``), and each metric's reader in ``metrics/<metric>.py``.
The plain references (``reference/``) and the work model (``workmodel/``)
import nothing of the port.
"""
