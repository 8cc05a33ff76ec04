"""Tile raw ISPRS Vaihingen orthophotos into 512x512 training crops (the
port's counterpart of tools/convert_vaihingen.py; reference
convert_datasets/convert_vaihingen.py:34-201).

Images are IRRG on disk and pass through; label colours become ids with
unmatched pixels 5 and clutter merged into 0; fixed area splits; tiles
named `{area}_{x0}_{y0}_{x1}_{y1}.png`. Images and labels ship in separate
archives or directories, so both roots are flags. Host code only.

  python -m regda_tpu_torch.tools.convert_vaihingen --image-dir raw/top \\
      --label-dir raw/gts_for_participants -o data/IsprsDA/Vaihingen
"""

from __future__ import annotations

from argparse import ArgumentParser

from regda_tpu_torch.data_prep.tiling import (TilerConfig, convert_vaihingen_scene,
                                              iter_source_rasters)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description='Convert ISPRS Vaihingen to tile trees.')
    parser.add_argument('--image-dir', required=True,
                        help='dir of raw image .tif/.zip (top_mosaic_*)')
    parser.add_argument('--label-dir', default=None, help='dir of ground-truth .tif/.zip')
    parser.add_argument('-o', '--out_dir', default='data/IsprsDA/Vaihingen')
    parser.add_argument('--clip_size', type=int, default=512)
    return parser


def main(argv=None) -> int:
    """-> the number of tiles written."""
    args = build_parser().parse_args(argv)
    cfg = TilerConfig(out_dir=args.out_dir, clip_size=args.clip_size)
    total = 0
    for path in iter_source_rasters(args.image_dir):
        n = convert_vaihingen_scene(path, cfg, is_label=False)
        total += n
        print(f'{path}: {n} image tiles')
    if args.label_dir:
        for path in iter_source_rasters(args.label_dir):
            n = convert_vaihingen_scene(path, cfg, is_label=True)
            total += n
            print(f'{path}: {n} label tiles')
    print(f'Done: {total} tiles -> {args.out_dir}')
    return total


if __name__ == '__main__':
    main()
