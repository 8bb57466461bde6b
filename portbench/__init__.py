"""The port's benchmark: ``python3 portbench/run.py --workload <cell> ...``
measures ``repro_torch`` on one card (see ``portbench/README.md``)."""
