"""Re-export of 2potsdam for t-SNE / feature-export tooling (reference
configs/st/regda/2potsdam_tsne.py)."""

_mod = __import__('regda_tpu_torch.configs.st.regda.2potsdam', fromlist=['*'])
globals().update({k: v for k, v in vars(_mod).items()
                  if not k.startswith('__')})
