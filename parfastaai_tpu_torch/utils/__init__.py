from .timing import phase_timer

__all__ = ["phase_timer"]
