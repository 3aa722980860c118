# Data of the port (reference: repro.data).
