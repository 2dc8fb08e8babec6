"""Kernel 5: the chunked RWKV6 WKV recurrence (`wkv.cu`), its plain
version (`ref.py`) and wrapper (`ops.py`)."""
