from soillib_tpu_torch.io.tiff import tiff
from soillib_tpu_torch.io.geotiff import geotiff, geotiff_meta
from soillib_tpu_torch.io.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    zip_load,
    zip_save,
)
