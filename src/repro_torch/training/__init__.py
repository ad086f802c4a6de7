"""Training: AdamW (``optimizer``), int8 gradient compression with error
feedback (``grad_compress``), the train step with gradient accumulation
(``trainer``) and checkpoints in the reference package's on-disk format
(``checkpoint``)."""
