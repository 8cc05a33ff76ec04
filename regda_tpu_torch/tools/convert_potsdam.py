"""Tile raw ISPRS Potsdam orthophotos into 512x512 training crops (the
port's counterpart of tools/convert_potsdam.py; reference
convert_datasets/convert_potsdam.py:15-178 and, with --rgb,
convert_potsdam_rgb.py:46).

Reads a directory of raw Potsdam .zip archives or unpacked .tif rasters,
selects IRRG (IR-Red-Green) or RGB, converts label colours to class ids
(clutter merged into 0), drops scenes 6_7 and 4_12, and writes
`img_dir/{train,val,test}` and `ann_dir/{train,val,test}` trees of
`{i}_{j}_{x0}_{y0}_{x1}_{y1}.png` tiles. Host code only.

  python -m regda_tpu_torch.tools.convert_potsdam /path/to/raw/potsdam \\
      -o data/IsprsDA/Potsdam [--rgb]
"""

from __future__ import annotations

from argparse import ArgumentParser

from regda_tpu_torch.data_prep.tiling import (TilerConfig, convert_potsdam_scene,
                                              iter_source_rasters)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description='Convert ISPRS Potsdam to tile trees.')
    parser.add_argument('dataset_path', help='dir of raw .zip / .tif scenes')
    parser.add_argument('-o', '--out_dir', default='data/IsprsDA/Potsdam')
    parser.add_argument('--clip_size', type=int, default=512)
    parser.add_argument('--rgb', action='store_true',
                        help='RGB channel select instead of IRRG')
    return parser


def main(argv=None, force_rgb: bool = False) -> int:
    """-> the number of tiles written."""
    args = build_parser().parse_args(argv)
    cfg = TilerConfig(out_dir=args.out_dir, clip_size=args.clip_size,
                      rgb=args.rgb or force_rgb)
    total = 0
    for path in iter_source_rasters(args.dataset_path):
        n = convert_potsdam_scene(path, cfg)
        total += n
        print(f'{path}: {n} tiles')
    print(f'Done: {total} tiles -> {cfg.out_dir}')
    return total


if __name__ == '__main__':
    main()
