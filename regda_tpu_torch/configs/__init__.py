"""The experiment configs, for the port's tools (`import_config('st.regda.2vaihingen')`).

Copies of the top-level `configs/` tree (`_base.py`, `To*.py`, `st/regda/*.py`)
whose transform stacks come from `regda_tpu_torch.aug`: the top-level tree
imports the JAX package's `aug`, which the port does not import. Data paths,
statistics and hyper-parameters are the same strings and numbers.
"""
