"""The run's check that it loaded no JAX and nothing of the JAX package
compares whole top-level names."""

from perfbench import harness


def test_whole_top_level_names():
    names = ['regda_tpu_torch', 'regda_tpu_torch.models', 'jaxtyping', 'configsparser',
             'numpy', 'perfbench.configs']
    assert harness.forbidden_modules(names) == []
    bad = ['regda_tpu', 'regda_tpu.models.sam', 'jax', 'jax.numpy', 'jaxlib', 'flax.linen',
           'optax', 'orbax.checkpoint', 'configs', 'configs._base']
    assert harness.forbidden_modules(bad + names) == sorted(bad)


def test_the_benchmark_loads_none_of_them():
    import subprocess
    import sys
    code = ('import sys; sys.path.insert(0, %r); import perfbench.harness, perfbench.inputs, '
            'perfbench.reference.stage2, perfbench.reference.eval_tta, perfbench.faults; '
            'import regda_tpu_torch.train.loop, regda_tpu_torch.infer; '
            'from perfbench import harness; print(harness.forbidden_modules(sys.modules))'
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         check=True, cwd=harness.ROOT)
    assert out.stdout.strip() == '[]'
