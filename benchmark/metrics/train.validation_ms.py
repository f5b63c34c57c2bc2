"""train.validation_ms: host milliseconds per validation pass
(`train._validation_loss`, every member over the validation rows), from
the harness's span around it."""

SPANS = {"train._validation_loss":
         "synference_tpu_torch.train:_validation_loss"}


def read(trace):
    times = trace.spans.get("train._validation_loss")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
