"""The benchmark harness of ``repro_torch`` (see ``portbench/README.md``).

It imports neither JAX nor the JAX package nor anything of the program at
import time; the program is imported by the system adapters under
``portbench/systems/`` when a cell is built.
"""
