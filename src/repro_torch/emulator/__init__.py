"""The fluid cluster emulator (``cluster``), the ground truth the
PS-cluster predictions are held against; copied from ``repro.emulator``."""
