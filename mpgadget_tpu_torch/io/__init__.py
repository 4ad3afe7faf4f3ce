from .bigfile import BigFile, BigBlock
