"""Re-export of 2vaihingen with TARGET_DATA_CONFIG exposed for t-SNE /
feature-export tooling (reference configs/st/regda/2vaihingen_tsne.py,
which differs from 2vaihingen.py only in re-exporting TARGET_DATA_CONFIG
and a worker-count bump)."""

_mod = __import__('regda_tpu_torch.configs.st.regda.2vaihingen', fromlist=['*'])
globals().update({k: v for k, v in vars(_mod).items()
                  if not k.startswith('__')})
