"""Plain PyTorch references the benchmark judges the program's answers by.

They import neither JAX, nor the JAX package, nor anything of the program
(``repro_torch``); ``test_portbench_isolation.py`` holds them to that.
"""
