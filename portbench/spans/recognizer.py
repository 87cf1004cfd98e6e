"""recognizer: one stack of line tiles enqueued on the recognizer in
fixed 128-tile batches, ``ocr/processor.py::TorchOCR.recognize_dispatch``."""
TARGET = "synapta_tpu_torch.ocr.processor:TorchOCR.recognize_dispatch"


def attrs(args, kwargs, result):
    tiles = args[1]
    return {"tiles": int(tiles.shape[0]), "batches": len(result),
            "tile": list(tiles.shape[1:])}
