from repro_torch.checkpoint.msgpack_ckpt import (latest_round,
                                                 load_engine_state,
                                                 load_pytree, load_round,
                                                 save_engine_state,
                                                 save_pytree, save_round)
