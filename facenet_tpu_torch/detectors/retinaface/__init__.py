"""RetinaFace-R50 (biubug6/Pytorch_Retinaface, cfg_re50): the network and
its batched backend (`detector.RetinaFace`)."""
