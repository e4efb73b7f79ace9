"""The plain reference of the collective write and read: a scatter of
every rank's requests into the file and the gather back, in plain
PyTorch. It imports nothing of the program."""
from portbench.reference.files import (  # noqa: F401
    control_read, control_write, gather_payloads, mismatches, scatter_file)
