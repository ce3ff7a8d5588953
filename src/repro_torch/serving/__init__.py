from repro_torch.serving.scheduler import BatchScheduler, Request, SchedulerConfig

__all__ = ["BatchScheduler", "Request", "SchedulerConfig"]
