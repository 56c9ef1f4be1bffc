"""Plain references of what the benchmark's cells compute, one module per
algorithm, named by each configuration file's ``reference`` key. They import
nothing of the engine."""
