"""The port's dry-run accounting: :mod:`.op_cost` counts a step's work op by
op on any device (``meta`` included), charging each hand-written kernel the
work :mod:`repro_torch.kernels.work` gives it, and :mod:`.report` holds the
count against the H100's data-sheet peaks."""
