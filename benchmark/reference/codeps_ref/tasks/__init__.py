from benchmark.reference.codeps_ref.tasks.forward import apply_encoder

__all__ = ["apply_encoder"]
