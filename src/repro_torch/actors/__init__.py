from repro_torch.actors.events import EventMailbox, SlotEvent

__all__ = ["EventMailbox", "SlotEvent"]
