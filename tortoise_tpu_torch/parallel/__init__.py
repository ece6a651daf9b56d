"""Multi-device paths over ``torch.distributed``: the ("dp", "tp") device
mesh (``mesh``), the Megatron split of UnifiedVoice and its collectives
(``sharding``) and the process-group bring-up across hosts (``multihost``)."""
