"""The paper's experiments on the port's simulator (counterparts of
benchmarks/fig1_divergence.py and benchmarks/exp1–4 of the reference), with
the reference scripts' constants and claims. Each runs on cuda unless
``--device cpu`` is given, and writes ``results/torch/<name>.json``:

    PYTHONPATH=src python -m repro_torch.experiments.fig1_divergence
"""
