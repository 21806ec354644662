from gp_emu_uqsa_torch.utils.checkpoint import (
    load_emulator, load_hmc_state, save_emulator, save_hmc_state,
)
from gp_emu_uqsa_torch.utils.logging import (
    log_event, profiler_trace, set_log_path, timed,
)
