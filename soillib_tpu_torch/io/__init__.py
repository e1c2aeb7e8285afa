from soillib_tpu_torch.io.tiff import tiff
from soillib_tpu_torch.io.geotiff import geotiff, geotiff_meta
from soillib_tpu_torch.io.checkpoint import zip_save, zip_load
