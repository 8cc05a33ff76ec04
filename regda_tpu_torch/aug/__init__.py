from regda_tpu_torch.aug.augmentation import (Compose, OneOf, RandomCrop,
                                        RandomHorizontalFlip,
                                        RandomVerticalFlip, RandomRotate90,
                                        Normalize, CenterCrop, Resize, Pad)
