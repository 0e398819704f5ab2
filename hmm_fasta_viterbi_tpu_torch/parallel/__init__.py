"""parallel subpackage: the device mesh (``mesh``), scans sharded over its
database axis (``database``), the residue-block wavefront over its sequence
axis (``seqblocks``) and the multi-device dry run (``dryrun``)."""
