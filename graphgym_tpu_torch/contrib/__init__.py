"""Contrib plugin packages (the port of graphgym_tpu/contrib; reference
graphgym/contrib/: sub-packages auto-registered at framework import).

Importing this package registers every contrib module's extensions
into graphgym_tpu_torch.register; ``config.set_cfg`` imports it.  Users
drop new modules here (or anywhere that calls the register_* functions
before the model is built)."""

from graphgym_tpu_torch.contrib import example  # noqa: F401
