from .quantize import BinMapper, apply_bins, bin_threshold_to_value, compute_bin_mapper  # noqa: F401
from .hist_kernel import (child_histogram, features_padded, pad_bins,  # noqa: F401
                          range_histogram)
