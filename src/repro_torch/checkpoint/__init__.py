from repro_torch.checkpoint.checkpoint import (clone_tree, latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)
