from repro_torch.optim.adamw import (adamw_update, global_norm,  # noqa: F401
                                     init_opt_state, lr_schedule)
