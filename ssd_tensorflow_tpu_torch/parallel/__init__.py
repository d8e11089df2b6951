"""Training: the train and eval steps (``train_step``), the process group
and device mesh (``mesh``), data-parallel placement (``sharding``,
``multihost``), host -> device prefetch (``prefetch``) and
rematerialization (``remat``)."""
