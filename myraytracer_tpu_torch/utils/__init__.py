from myraytracer_tpu_torch.utils.profiling import enable_debug_nans, profile_trace

__all__ = ["profile_trace", "enable_debug_nans"]
