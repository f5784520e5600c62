# Source: open_whisper_kit_tpu/io/_iq_tables.py, copied as it stands (pure Python and numpy, no JAX).
"""IQ-format codebooks (GENERATED by tools/gen_iq_tables.py).

Format-defining constant tables for the ggml IQ1/IQ2/IQ3 block
formats, extracted from the normative source
(reference ggml/src/ggml-common.h:477-1616). Stored
zlib+base64-packed; bit-identical to the reference by the
goldens in tests/test_ref_golden_quant.py.
"""

import base64
import zlib

import numpy as np


def _unpack(b64: str, dtype) -> np.ndarray:
    raw = zlib.decompress(base64.b64decode(b64))
    a = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder('<'))
    return a.astype(dtype)

KMASK_IQ2XS = _unpack(
    "eNpjZGLhEFBwaAAAAf4BAA==", np.uint8)
assert KMASK_IQ2XS.size == 8

KSIGNS_IQ2XS = _unpack(
    "eNoBgAB//wCBggOEBQaHiAkKiwyNjg+QERKTFJWWFxiZmhucHR6foCEioySlpicoqaorrC"
    "0urzCxsjO0NTa3uDk6uzy9vj/AQULDRMXGR0jJykvMTU7PUNHSU9RVVtfYWVrbXN3eX2Dh"
    "4mPkZWbn6Glq62zt7m/wcXLzdPX2d3j5+nv8fX7/ZoM/wQ==", np.uint8)
assert KSIGNS_IQ2XS.size == 128

IQ2XXS_GRID = _unpack(
    "eNqFVVuS5CAM++UKOoPuf78ZLMmYLLXT1SkSYvyQZGct/egVuDfoFQtPA34M6RXLB74HqR"
    "W/N9rm5ZBZmWc5hK+vY+ATII55Oz4Xc1+OMZ2PANgWtccrIBOYqYzwEdoH7cfP5EyQSZRJ"
    "mNpHlbLNMZHCBghKgy/kfh/pOLPgxOgrwUkXoRKrCjo7OpsJlGOXAY+LMhvQfIGM8/OST2"
    "CBvwAWw4JlAk5ZIEC/AZZ7Gz0A54Z5AJ4rkTr1hYuAijSIEEdlXMqryIOQ7paoHJEMMaVP"
    "r5LNJGRq90isoTxEVbGC6xCHFaiptZQ2CXVH7Jcidiuqkf2HaGMR8XTsdXUBrOaA1wwdge"
    "AjFOca+ZsFwOu65FtxRlUllEtQfAsLlCKiobobAotS+sSnwyXK0elKQHnT7Wo7wXjB2T3X"
    "Gr/hOQJmhKxuiaqLvuNeOMKh91qGAl9aAOZkESSOW4KnIS9sJL3/NQJ5NYRiUX9pGrNBgE"
    "ysAb4ahXruSTY/O/mcdAJRbDOSXlzd1WuOymbMktGQnRrkNQF7LBgFz106e/rDkjZmRpFm"
    "1KMx3WvRuqemoa19esbHuBgw7VKggELYclb7VH91Xf5hzoD21KEk6CpbkT/vBJbU", np.uint64)
assert IQ2XXS_GRID.size == 256

IQ2XS_GRID = _unpack(
    "eNp1V9GV5DAI+3ULqkH99zcTkDA48e7LcZtJbBCS8KyVP1QE5g0qYmE8QEVwvkBFYC6ApQ"
    "W0EBX/j42FqQjMjbD4uSEV/0+NBLAwEvm/NhKCLidGxeepnigVn3R64lTE4mchVHxe64Vh"
    "4btAUp+r0EvBvp6HOwBY+AQCS0AcgDzbd0D+/5ANk9WT8SINMCpGFQ3A2P0DSCoGjA1YLA"
    "yAeQDtrW5AGwtfBh4Lnw1wymcjkDtXQ1zS2ZCHRr0xdIMQlKhGuTfOyRcVDcrZyOgKN5Sv"
    "xvJkOpnrZjT0t8arhBVlDEVwEOG/DXU/IoaKUZiAkzBuFjAJhMHGTSSXCkxiYXRrE4wkOq"
    "VuhDN0wCSgf08i+s6LkEVERKSi33TKvBKVg7BupblpDjiDk8jOyMXEYp3Ykc4muDO/Er0I"
    "HrXEemyVnsTnKQDEi/lRE4JTIQohhEc+9GnCMHWd8urcK7d9C8dIX4WTrK0OXAXEjMAUkn"
    "9PQbmTp7BAfgosEYo3IyIBKSYwMXouDgF2E+Y2i2hafs7MzAINhWqyUY9TWO4K8k+9xc3E"
    "NYeLh0EJ3JVjjt9i8Cl8I4Q5FqEti/GnMUDuiTnGXkbhm5hjppRzGgjmGHgZCcTm7MhW3G"
    "ksVMS01zIao4Fpc6VcZ4FpW5Xb3ZCm0l8GhSH3R2tdxkkJrd0NDFNmrwkLqHdImbBMYNWW"
    "6Bkm3UPsur8azUoZmPSp1F9GSA4HuxkjJswFdq68DZLnCUDIMdVQzngaJ+Y2ydcsY4uyGy"
    "urSupvov1nZYOQE6wZMXzoyeFiY0aahDxU9VD1fCx0NXDlTp9e0gQ13Zuxh2eFlehoEIwv"
    "l6ANvsic2o0KkIwD9lk2TD8SpMi5cnYDcj49M79m+GtFDQoXdg4MH05c8G1w2FltjnqxAL"
    "ICeBkwG0AcA4dj8LD26q67AT4Hkzauzm/30DEjh88eXFJkCi1nbyBM97QG2UrKOYt8etUE"
    "8ajTMLEJerwsf5JRTKGQK0LcBqMKYtmnbDLLqdNGMSP33gPUTC+HsYxTK0nQvB9LUDHZKY"
    "tjMC4olmJHSXDpQ9OOa4/8RqtqLTlbrDbUirFaO0GbbKtIwPNkvb9qoQkkksycQxnuRD/c"
    "sy2hiV5Xop9H0TxyEW3w67E6kfnnB+/mPr4=", np.uint64)
assert IQ2XS_GRID.size == 512

IQ2S_GRID = _unpack(
    "eNqFmWF25DAIg//6CjoD979fG5sPI2bS7r48tttJYoOQhGet8ycySv4fkVFL9oHIqPAbIq"
    "PkD9DKB+SDIuPvx+zBkVHyF2mFvTAyKnwBkfH3LluQlr4u7PfHc1/kz3mx4Mj43NU3EBmf"
    "ZfYNacXXjUXG5+N9o1qyDUdGhSdAykRE/rwyISMxkVHKuOJrorieh/XEaelrAp/0RKalJz"
    "QyPtvtCX620RP9PO48xxMf6yRePflsjpe1gkTGnZ1WoL3aVqjIuN/SChcZd9laISOjlqyw"
    "kXGnvxU6Mu40t6UBgMiocEDstJx151Yi7wsDDLXhAkCRUUsGqMi4l9MAtl+nk3i11AG8yL"
    "g/1oAYGSUHplZ8BWhklBKwkT8vfQUwpaPWXAoHtuQAlxzoWnLAJzPsVP3RAGCe3HIBktU3"
    "Ffny1igb3XH6IqGn3kCRcVe5NVRk3NmMzF7kbiN32Rpv/zayrSJ5qkF9NmRk3LBtDbrh2B"
    "p0wyUSJpFwsMYN9VbaC2sNrSVr7FhhDR6j0Z+7eysuIy/VHpaxqAqsgEXGQsrFXYKgFJIT"
    "hgz9oBh0XiKJ1VEFii51LKvWJRzJiUeZpUlAQERyQiKn/IWgIuOhmUtYkfHQySUw7iQFkf"
    "HQwCW2yHja+xIdb5yEB6RPO14CZGUQISsk9WCSmh7Y3x1MgjywvTuDMNnhG2HSYnAiPUxG"
    "VicnSKQRK00BwZLB1Tddi7vEGxlPGi8Rk/lJyFAAt5403ApNwqZiq3Ehvd2JnNxyQexUeh"
    "I8FMTSIXwQMYkfhLwJAFuHM0HSFASQ9SYMD7915NGaoWY2mnCwVy6QunqTxi3JTlRD8hWY"
    "MGQXFTRKVispmkAHTGGiI6ZAPSp0nhd/CtWT3C5YSAJQQovouNVFt1zgFTbIPtJ10aFT8A"
    "AloJjCd9TnCmCkANLhUwjp9cLickFE4qollr4KJJbqTShLg/LvWWikb42UmC6k+Yna0vkk"
    "TAS1h5q5bYJLT2FaEPu67hsv+TaBhkymUJ/kd8F2Zw1FUAKYcgo6zDmFPXbbXoHHil6hlw"
    "m+Nlyv8Bc1rWZGGzNPY3CTfH6AuUsadzridEf3DmAV43AfsaN8LGUMZegog0FF5WMkvVXK"
    "sdzklBEBCfLxDvEpxVlOipBaGReQVGTg41YZGopFMUhmJcvHopIGWk8+xqDic0xBdVVY8b"
    "GiqE4+NhTy5eNAKes0VHQIbAu7yu17GS25Da+t0WHSMGAyO1zSSBfJ7W0ZNLmNLYMGGuR2"
    "s6Aqt5OlZXKbWJ0vt4OV4+W2rlp5uV3DnpURlNuuMoQwy7BX006VUZTbo5Iwuf0pppLbmu"
    "LsaSypgdx+1COm4dxq35zTmwGFIeUyX0uaxlQuz60FNtC2unZnRibl8liMjEfCQ+DkpsEF"
    "e0PuprzdE4IXIwzzy+WlUl7FyUXK5eDjpCFpfNL3q6FGceQ0WaVeTnOT1kpr5TRWXLKcli"
    "YN1Zbk9FKmbRp4FBHzgLWQ00CR9fK2LZJY3o4FWkAmb6tKBi+Rt0ddc0CQw/djUJDDrFpp"
    "Dg5yWFTuHoHrg4S8fGVJ5WUp6MjTXZ5sDh6wnDw9tec5kMi38zGYgBr5a4s65sAi//XH4M"
    "I/5gATW5E/BxmcETdiQXnAHHR44Bx4zjBzTTkv+m8A2q72vD/6QMQCl51+3wGJVmfhzDRs"
    "YA5ObAguYmPvA5WfzGFSSACiTCLmwEVi3gYv7S19HcCaa82EtMGMxDISkOA5qJHwt4GNQr"
    "wNblhUigSlVjVOx1UhS2nS2nDvTl0b9LaXjeNJesGXf/3C1y01CAIEKIOlMKsVkpd9XVGD"
    "ItwAYMAqNeGaAEIhARJKiblafpxeQKO0AK7Ey4+1C4iQHICk6bkKXFnkI+d3UKVD83i2gA"
    "ylAuhS8NQQAL76SN4Av7pktgYAsjTC8mO9agw0nwYpLswlsrc7KPsJMmpKQ6F2NFZJRG6V"
    "RnsbrCObiuLPQVun2z4G7kLNsmODatzaba6SSZCGLseTZmGTYBsXD4ceDvQj5TACwDExvi"
    "0fz4og3gZ5JlGIg5VBIHPQB3NvA/8kGqQZwpmDf9rfIqK3AwCYYvUvLa/9qkxCYPOgAEJ7"
    "OzA4hwGX8P47QIAIIZs4m9+02IlxHjDESWXNuDrVrOE7V1EnAkmLdQABwfKtLXRW31Lmlx"
    "AQ7zyoKCgdZihzelIZ9ztJjhxWPyWKPCXi5nm6cf8Jwb8deBykxb2yrCUlmYaoL1/rjOq8"
    "XmeEyR6tI6z6mK+2LS0/ln9+AIHIjsQ=", np.uint64)
assert IQ2S_GRID.size == 1024

IQ3XXS_GRID = _unpack(
    "eNpFkzEOQzEIQxdGRkZGRkZm7n+sPpMv9UdW0jQBYxwzswAF3M0SrL/NAJ7M/Jlr1sAZCX"
    "Q4gIdbx7sYwMut+h9Eo4D7CxjAMyzBAm9m0BsXeYGSBuhgvUnoYiqrYu6CS3G+ON+cb/KC"
    "buscqxnurxUYkLXms8c4H31RFh3RuGJI4wW+kFecGOtTkRFvIVa6raFNS1b7io9PAM/0KT"
    "CsYdHAGkR7gUEc32Z/CIFI9YSSOv4kPNEk1cRLiv6XWFShd2KKgYZSJ6EWoPmJrOt+0Z/g"
    "+tCaRgQyPeKqvvw1oUBnISNA9Q06Ws2+OrvsbaBldL1i7Sp/RauVaJY97H3Ni6+BGkWSAS"
    "qNzVMbCiQE+wTTR6Noa7FHJ66TDePObpj5pEYiaiaGGLnhlKtOZoAFoItFFrPElYRhwASW"
    "4DcJuqDDEW+cNEWF2ukzFU4qOSDkgtRsNOwzGC4dIRw63PZj/4SidA0cBOHCxoTdkqPbU6"
    "YcVN0Ts8LIajOgRgbw0aBP/A4UvApH7HSRZr2iba/Deg2QWZ6hDP0aA0N4neHlRiUTM71Y"
    "CKwEs0lSSJm6V6zXhheRZPYHxKhj+Q==", np.uint32)
assert IQ3XXS_GRID.size == 256

IQ3S_GRID = _unpack(
    "eNpFlYuKxTAIRAkiIiL+/9/uGe1yKUPaNPU1o33vPQMOCsy7DQMOEvR3wECBCJ6TLVBggP"
    "FxyECzDwxDCeYzqMtBfsYN1OckwAAL9kDi1HBawOec6+sC8wUSoIE5+66g/CXw5BkMMIIN"
    "BTysApdZ4JcEPJ4DI5kADTLZL/bBNO+Gs3PJhuUbYCSdwIOkk31gXxEUYaqKTqSgQVAUyy"
    "Km4gh7zd6wcpk1dlmj+YR1ehlQlikmnHvQIILnYr+uoHZ0WH7FtSufFZiv2JRF6RppmdLB"
    "veFebg2TS4TdEW2tlQTm3Af7cRsiykXWcG6ONF0FBhCkJXARmW4Bqrhv9uaMqYJksVHq4r"
    "ANIDHi4zlhtHke3qI6Konl3AuDxMIzwmiJo9itC0wZh12AkI1Z7ot7b2JqfLBm811vAjC7"
    "FVLkBGcVrMkziSHWFZutOsSiGDjxKctcq0qe9wBJSVSSEaGuJLxOBqLfoXMFC3Ven3BFy9"
    "vs5Z1nrJWKSfoqgedXWEzksq8TuABo3Ceu2OjaB5Cg51wD6ECpmyz2ixQhEY6+OUTEFd59"
    "JKGkbRadInAkD2nJPY1TI4UTFQ1EIvikibLwyTpqqMZXrzIpnFexttQusqm4X8MFgaHZDc"
    "6WaTHEG7tg7VovaDfC2FaKkVDUNv0TjLoU2YaUYJvRSoSmJVEo7bmGlgLFhi7SpXlPYG/V"
    "g/utRCiy9SzhcRCfdGlxPwonV4yoZotmslR0UGck0IRCc/gqqsJK9JkVLQPDSqdZnpDRGv"
    "HMsobOdpBoaogA1EC1nyoECWSTOzrU9ppcjM5txQ1GjKuFShGrIYp7IEmGpjDSQTIp9UTc"
    "gIIm5M/9+E4pNZGSkUpFuEpCxDvEFAqf5IgBbm1yJ9ao0UjemwKo86KTAYY/JpnNsgXHxK"
    "NpS/TbmTuOdxBijTc8Y6z7DKphVcDSdLZVulgqtaJaTo0cvjIupLpF1hSftxJATYFdZMQb"
    "Dqis2GQaAEqBrSwiLU0gKZNFJ6lGr3hTAqZz0KNIaj5uu/HfezEi6eZGyRoZK3AU0KomVl"
    "oXNeUcxUB6aKqRTMsB5eNt8o7IAGFisVpT/2UzgPirfEM+79e4w5566XezQ1+/ifWgIcUH"
    "iAVajMA11l1/mdH0bo0PjQd1QP03nBQYKzZqwl8GSiUlXyrxQ/n4gdC72zUK4Q/ZMDHN", np.uint32)
assert IQ3S_GRID.size == 512

IQ1S_GRID = _unpack(
    "eNp1W4tWJEsII///0ew6lQTC6J7rxdaeflRBCAG73z/QVuUPQFtd/H2egHMiaIsfKF2RHw"
    "RtFeJCOBcE7f/T4wY4N4Jv+Pnvc7fi89Z6END+3PZzTPtz+eLH33nP/vz4c8wHr3oWfIH6"
    "XPFd8H2OxwDPb/A5sF8YtP9NLADOQoD25257YXAWCLQ/rweuN/hY4PO9Y8RC4iwoaH8uw/"
    "uC14kFx1l40NbZANB+noLffv4H2nobgrMxJfvOfI//fo59C22YvuDvKzYStJ+PL0/8nPb5"
    "fdsj3yNXbHjRQseo8GTQViEcBLSzFM9BqtJhQFt2HPC8Z6FjpGP9LBO4rr85GmirjuN9bv"
    "z8F+/67xi0nwehHyxH/fjBclgcx5VTcVF8Eo5Dg/az6yA+gKsJPv1yeBzHB+0HF1Yg4AQE"
    "aN/aEQ9WoHzcDAx0EAcwLivkKdnSMSLAPtsDLj+4/OByv/uA148AxAlEfX2WYQUmToCCth"
    "io9SLjPQ6fD1zHHbha+s/lVyAD+nlFYOMEOBToga7lYJQTHhRy6F+AqBsd4c0l76UXavcG"
    "ULzqHavgp+u4atkH9OygfTD0AGT/RkD1YKceXry7CbBqXwG0AraihY5RkYkeDDAQ3+fBz/"
    "FJmKEK8WQvXF72AdcZzHTgxUD0BJ8LfB5wvUG02QAL2ud+8+YCXtA+N5ncSoxwbPUG1wXM"
    "AhcGeTMouE1c3OJiPAxZDzM7IIAvWugYPCbwv2XcCaDB50Rk+Hq2aD8PVozmB4bYO69EUr"
    "J4Vrlaj6hYlodoTfQFfQ/+nh4EeVIhEhSQHtazBFVct+15OAmsaKFjJjQgPVUJrmihY2Ti"
    "E2T3bEEkRCgx2vMrEmXRQsfgMTKRgvblw4kgQQdzc8PHjA1+Nfg97fOQ53+bwUFMblyJCZ"
    "q/p3XkMpFDCR38uawS/Huxh8cr4RctZEkAAFoSgaokAD8GC7P0jvWSjhFF4IdaoIAhEHKa"
    "jpuTOGE+LKIB2gKtQu0TUYwjMC4WIUGPjxeIahvxCjxvIL9WCIvICBlFaIoWOgaPkYSn3o"
    "Y8PgY+LZ+bzwdeLwgRPfHxr/feEGfA8qnPBUF/WilLS1VIIgXaKhIr8Pjd6d2eHyZ0gRkA"
    "vO+zeLajChtiJg4hbOmoHsD8PMRNpICsfEBYQdCbVQ7BwyF6YmOPLQ3xE5t5eXqIoNiGIb"
    "onR0xWVBYTpRviSJQ26nWgxmRKRTmjltEJRgMJ3cOG5RWYXTuEVG9FRDF2a41xCCtonYKY"
    "uUEi++gkSB9fpt5LCtqXl8H6bAgvDvEFrVKdiDCxhPmYfrAIck1ID4moeXImA4ItwcpBhd"
    "mUQ6xfPgXzKP1gn6Kcp70GgogrRcu1xGhEzEv2AYJX9qUXMJ2AS7AJ/LNF+xwDhOlhSiL6"
    "oH1wPJSBzJseR0zj+mIzLS1FsUAw86KFCoZHPRjqruAfLEwhgVNQqFYQd+hdNK1CQ+Tf1K"
    "YXaQHjfBUiOAUJTmGCU6CAlktnRqnChZjqvVbqkGvIw9+2DgNVoQPatx2M46VYgAXQq7+4"
    "f2A8r8IIp0DSK/SK2V0o6cvUj4wYLKDeYzGOV0GFU1hpid7HptDCKbhAa+2it+pkecwyli"
    "K+UqaqP2QpJr0p2FzFdsg/1VHtTYmFI/MceedUOapmVMV8yzsVbN2yjSuKTllGcozkl5Ls"
    "UimrSD5xRdK/yyhGRrGNZlbPbG+Z48oY5pKUJyw/CGmFWkc2kDzwoGcVtCzLy2JqZXlsES"
    "DL11u2+oxTjrriEuKf8rNEPkQKkGWnt1ygL3DuDSqrbDzloksjQUNluVenvDM3FFdRblBM"
    "1inMT5nlVNNZPnllTnnkAt5lUUc5U6d8cZkCF/pRlqj88CudcsLlQ2WZoDKARHbKAEudtw"
    "xImu9a4A/6LtpuJVYSWR263knPS/T80HDRbjODSlo9lblKAsjjgh5f+lukvVMyyxVEV0VT"
    "yRXQQR8NPZX0UDTQHn7pn0vzpG9ftM3JS2B86BYIBla4k1a5Vjs0aujToUtKoQqFQ48uLR"
    "IdshBEOiT6U6I9ojeXxhz6UtQ5TV+kmJCuFOnKq1pWLd2/04Cb7p3emYmUvo0oTJ83PZ4u"
    "01eatMiv2qyyi6Luh0XOyrRlqOlMR3XSj4tWpQ2c9CASa0EsVGCpuJMGBP+9tenvNGAQrV"
    "AbR2CrI7TJaY4KaNiuhOc6cGwf7IRdu2onvF44rQOfVsg64bEOHAruRgLrgKc6cCQYGvgh"
    "zODAiqvdDrj4Cw6c4xXOorJ1BMYThq4+GF4KK7Pw/j086oTDyoDh3k51nW5q9+xgO27CuL"
    "bq393PGbbSnYw9x23sA51uUGe762yvtxW5vXW201njCqkqJSq3o87y32Wvr+Um2mhZkctb"
    "dZaxcrnqLI9DovK167yOk1XnY/txKx+rzu29S+fyduo6QnHlj/1p/cMRkvUDIDulOqErT8"
    "QRnvVBnAt0nQuBUh9SqK4jWOtGOAL2vXFXPgDOg0joppLISp10g/u8hfBCPnhXvkAvrXIL"
    "5bU0IDHH/cLUqS2o/7UA4l69cj3oHlt4r4U9G3q1cDjCvBYSZ0G7zsJSuJfSUiPFhpBPyY"
    "h873sjwI1AIzYEtA3+nFYNgdo97rVhahTUaRRo416tPRvXu9m1NrIrNxSn0VCn4QCJ85Ub"
    "j84N76FgsfF9Nx7ZUZGCJUeQNFKngVG7qNiOUukYXekgOI7SG6wXZexKB8JpjOgLx7G60s"
    "FwHa3depJjheN1pQPqEtTv39FyTM+aHAeFeh/HQfGHo6oxU7Jd4cB6hV7vvJVDIQ2FvEeL"
    "18gI6Pii4AoAnvpULjBOIiB6TS/BQyY3INw46orA0JJ3TJ1MwHRMi2CaF085s3hKfd/iU6"
    "9Zk+nak2X+EnhWUOuPQMTvAYkbmNsZtGirEgYDFDdAe3dh3G1x6a7ugboFHao6XPPWclls"
    "TLiB3VvNXIEe6tgEunuKqOhcathEQNBLW9rA0KuW2kDRlYCBAxwQltEX0AhAaWeeXRWPpK"
    "bSsaMadbXprcgqEa4SLa5GFTWzLhfAcICsKwEMB8g6WNhwzAry8A1wXQl0OIAHOeVI0r8C"
    "IA4QQrYRwEjUcENTHQS3LsqTXfR+emV42Wi/dRqhksy1il0JtPlW8FP1Ad6n84CNfJAXTI"
    "sfsBLEMysarlqCbkQDFrLQMYEd5R6PNF8PbyzAF/a66Y3DUE5DV08qEd0ids9MxE4MvXo4"
    "Fi9WA9ijfX7zbAyr+OlNqjGpTK7QJ8E4KRC81VDGH4mnh2llIuo1k0CxEEtDlxKnBNVdka"
    "h6XWordmZw0A62Sm7wc+DnsHe4cwzZjW6chjdO41u9FzHEM97rxriGTW7C7BzDdeNcLaM6"
    "DXScRrqaOmagvUTrGXulKKqprEnMEmfUYuwcV3XiRsUYqhN553jpd0JHNvQVQTfBd453ug"
    "WulpmYdOd4pnuG6n1Jq5EyO4QBMSiAMzCgllydwQGcAQKcQQITjo5xP3UPTDzk8mcMzzEk"
    "CciEpEOtc5NDBMWidU1Pco2HwapLxbiXNazOMS0jl6Adh+gIUzvI4Ez2dI4/aezJrSol2z"
    "qDEQILLY4Q0+NAYjUdYz4mVMixniFYOY7jSzprKAvomdmyIGoJdTwhrKjvHGNxid05luIe"
    "tryHvcYheF0x0PFF+N7djQk4Ax9qGavC6xzf8Blq9tZuKq6WTN/xClWIPb03fm7EwzUZjR"
    "7NxMX0IqJtTtLYJY8pA8cNOscK/EYKQhHZzrEAH6jXbaKb7X2XWJ3td6+UvkSMO9vnXkm1"
    "yz3S19H2NlU39VEF3dGW/iLcne1jE29cAp5tXg+N/EXMO6ebTdQ1iFNnEEepV6HWu8myCL"
    "2aGCL2ne1Pi4kVU51DBbVV4qidbUOT8sr2nif7OqfXYBKgpNQxtTXUk07Z+yKrcOhsd7mA"
    "UGSIcd0CorONBAq5/lOJzjaQZ8xVaCji3J3vaIu419DZ1jDD62xbOBVWdF2nUOlsM/gdOt"
    "sGjngP6yAHpqTYdMr37hqpIOqU4c1ATf0bWSilHO7CqVPGNoOVXN0pP1tc75SVzXg7VVtT"
    "TKWSTpnXDNlct7cqNwNhlbKo17RSfXIxc2RNQ1alTAkgJ09N6jpUCRwZEPijMOzVW92TrO"
    "ioQv0wt4DUABsf3INswnrICqtSvnIHWKydeqv/dkms0qxRrK43e5reptiQ2AwqZBlrAMMS"
    "esspltCcpVjZdMoh/pubTpnDhW4nKnFIYArgThTxTJTkBkVzR9RNodwpF7jykldpt+uU+T"
    "iFtDlnluX2TRXDLqcryuFFDhEdeYGzQFPgpiDqr0I8C/BeMbErx86yzMxB5ZjKrc4yysxC"
    "ZZPLo45yxxKp3rCzDDEzEUdQzHaWEWYuKhuWUDBDT2swUhWxhlcgmzR/Rllq//WD6bgprV"
    "KTBIhOumxxx3T4DGDCg5gk/Y+OmjJ10sslaAQNHM8gJHTSOl9MXEvY10nLfIpomP+YUDSo"
    "9zTaHgAN+mGGqOkm044cvkcnvbDwctI0Tpq24KK0K1dWF11p8gownWnJSscVZJQGVDu3Ow"
    "BbRJ4Ik6gpGBemuVjvgEdLJC5CCIudcAaTnA74wYEfgjV44/mTgj7CkHKAMYalGPfEX53h"
    "bkaPM2CLM2ircFT13Bk2RqBO93eFIHdXLu50W3/JTcXmNTJh92r8KmyJPWn7le21ragUvL"
    "o3mo8YhTMIjDMQjDMYrMeWQNZ5e68uzuCwPq7TO3/ss/TvHzM5DA8=", np.uint64)
assert IQ1S_GRID.size == 2048
