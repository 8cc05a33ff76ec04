"""Offline data preparation (counterpart of regda_tpu/data_prep/): the ISPRS
tilers and the superpixel region maps."""
