"""contract_roofline.prism: the least time of the two full-grid
contractions of the window's real rows (2·2·C·L operations a row at the
fp32 peak, `spectra_work.py`; pad rows not counted) over the device time
of the kernels launched inside `BatchSEDSimulator._intrinsic_lnu`, in
percent."""

SPANS = {"sed._intrinsic_lnu":
         "synference_tpu_torch.sed:BatchSEDSimulator._intrinsic_lnu"}


def read(trace):
    device_s = trace.span_device_s.get("sed._intrinsic_lnu")
    least = trace.work.get("contract_least_s")
    if not device_s or not least:
        return None
    return 100.0 * least / device_s
