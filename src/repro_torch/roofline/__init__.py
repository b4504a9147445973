from repro_torch.roofline.analysis import (HBM_BW, NVLINK_BW, PEAK_FLOPS,
                                           POD_BW, CellCost,
                                           model_flops_for,
                                           parse_collectives,
                                           scan_corrected)
