"""The RGB-source Potsdam tiler (the port's counterpart of
tools/convert_potsdam_rgb.py; reference convert_datasets/
convert_potsdam_rgb.py, which differs from convert_potsdam.py only in the
channel select at :46): `convert_potsdam` with RGB in place of IRRG.

  python -m regda_tpu_torch.tools.convert_potsdam_rgb /path/to/raw/potsdam \\
      -o data/IsprsDA/PotsdamRGB
"""

from __future__ import annotations

from regda_tpu_torch.tools import convert_potsdam


def main(argv=None) -> int:
    """-> the number of tiles written."""
    return convert_potsdam.main(argv, force_rgb=True)


if __name__ == '__main__':
    main()
