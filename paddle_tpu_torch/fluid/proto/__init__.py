from .program_desc import program_to_bytes, program_from_bytes

__all__ = ["program_to_bytes", "program_from_bytes"]
