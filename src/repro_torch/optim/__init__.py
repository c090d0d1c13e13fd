from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, lr_schedule)
from repro_torch.optim.compression import (ef_int8_compress_tree,
                                           ef_int8_decompress_tree)
from repro_torch.optim.sgld import sgld_noise
