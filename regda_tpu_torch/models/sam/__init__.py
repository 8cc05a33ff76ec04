"""SAM (segment-anything) in the port: counterpart of regda_tpu/models/sam/."""

from regda_tpu_torch.models.sam.auto import (Sam, SamAutomaticMaskGenerator,
                                             SamRegionGenerator, build_point_grid)

__all__ = ['Sam', 'SamAutomaticMaskGenerator', 'SamRegionGenerator', 'build_point_grid']
