from phnrec_tpu_torch.io.htk import read_htk, write_htk
from phnrec_tpu_torch.io.weights import (
    MLPParams,
    load_net,
    load_nbin,
    save_nbin,
    load_ascii_weights,
    load_ascii_norms,
    load_window,
    load_phoneme_list,
)
from phnrec_tpu_torch.io.audio import (load_waveform_bytes, convert_waveform,
                                       ALAW_TABLE_D5)
from phnrec_tpu_torch.io.labels import (
    Label,
    format_rec_line,
    write_rec,
    read_rec,
    MLFWriter,
    read_mlf,
)

__all__ = [
    "read_htk", "write_htk",
    "MLPParams", "load_net", "load_nbin", "save_nbin",
    "load_ascii_weights", "load_ascii_norms", "load_window", "load_phoneme_list",
    "load_waveform_bytes", "convert_waveform", "ALAW_TABLE_D5",
    "Label", "format_rec_line", "write_rec", "read_rec", "MLFWriter", "read_mlf",
]
