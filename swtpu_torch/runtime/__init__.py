"""The native host runtime: the port's build of swtpu's C++ packer."""

from swtpu_torch.runtime.native import NativePacker, native_available

__all__ = ["NativePacker", "native_available"]
