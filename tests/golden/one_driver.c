/* ONE-code oracle driver: exercises the reference ONElib (vendored in the
 * reference repo) on arbitrary user schemas, as the byte-parity oracle for
 * modimizer/io/onecode.py.
 *
 *   one_driver write <schema.txt> <spec.tsv> <out> <0|1=binary> <filetype>
 *   one_driver read  <schema.txt> <in> <filetype>
 *
 * Spec TSV, one data line per row: linetype '\t' fields... ; list payloads:
 *   STRING/DNA   literal bytes (alphabet restricted by the fuzzer)
 *   INT_LIST     comma-separated decimal
 *   REAL_LIST    comma-separated hex floats (%la) for exact round trips
 *   STRING_LIST  comma-separated (no commas inside items)
 * Read mode dumps a canonical text form of every data line to stdout.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "ONElib.h"

static char *readAll(const char *path)
{ FILE *f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "can't open %s\n", path); exit(2); }
  fseek(f, 0, SEEK_END); long n = ftell(f); fseek(f, 0, SEEK_SET);
  char *buf = malloc(n + 1);
  if (fread(buf, 1, n, f) != (size_t)n) exit(2);
  buf[n] = 0; fclose(f);
  return buf;
}

static int typeOfLine(OneFile *vf, char t, OneType *types, int *nField)
{ OneInfo *li = vf->info[(int)t];
  if (!li) return 0;
  *nField = li->nField;
  for (int i = 0; i < li->nField; ++i) types[i] = li->fieldType[i];
  return 1;
}

int main(int argc, char **argv)
{ if (argc < 2) return 2;
  if (!strcmp(argv[1], "write"))
    { if (argc != 7) return 2;
      char *schemaText = readAll(argv[2]);
      OneSchema *vs = oneSchemaCreateFromText(schemaText);
      if (!vs) { fprintf(stderr, "bad schema\n"); return 2; }
      OneFile *vf = oneFileOpenWriteNew(argv[4], vs, argv[6],
                                        atoi(argv[5]), 1);
      if (!vf) { fprintf(stderr, "open write failed\n"); return 2; }
      oneAddProvenance(vf, "one_driver", "1.0", "fuzz", "2026-01-01_00:00:00");
      oneWriteHeader(vf);
      char *spec = readAll(argv[3]);
      char *save = NULL;
      for (char *line = strtok_r(spec, "\n", &save); line;
           line = strtok_r(NULL, "\n", &save))
        { if (!*line) continue;
          char t = line[0];
          OneType types[32]; int nField = 0;
          if (!typeOfLine(vf, t, types, &nField))
            { fprintf(stderr, "unknown linetype %c\n", t); return 2; }
          char *p = line + 1;
          I64 listLen = 0; void *listBuf = NULL;
          static char lbuf[1 << 20]; static I64 ibuf[4096];
          static double rbuf[4096];
          for (int i = 0; i < nField; ++i)
            { if (*p == '\t') ++p;
              char *end = strchr(p, '\t');
              if (!end) end = p + strlen(p);
              int len = (int)(end - p);
              char field[1 << 16];
              memcpy(field, p, len); field[len] = 0;
              switch (types[i])
                { case oneINT:  oneInt(vf, i) = strtoll(field, 0, 10); break;
                  case oneREAL: oneReal(vf, i) = strtod(field, 0); break;
                  case oneCHAR: oneChar(vf, i) = field[0]; break;
                  case oneSTRING: case oneDNA:
                    memcpy(lbuf, field, len + 1);
                    listLen = len; listBuf = lbuf; break;
                  case oneINT_LIST:
                    { listLen = 0; char *q = field;
                      while (*q)
                        { ibuf[listLen++] = strtoll(q, &q, 10);
                          if (*q == ',') ++q; }
                      listBuf = ibuf; break; }
                  case oneREAL_LIST:
                    { listLen = 0; char *q = field;
                      while (*q)
                        { rbuf[listLen++] = strtod(q, &q);
                          if (*q == ',') ++q; }
                      listBuf = rbuf; break; }
                  case oneSTRING_LIST:
                    { listLen = 0; char *o = lbuf; char *q = field;
                      while (*q)
                        { char *c = strchr(q, ',');
                          int l = c ? (int)(c - q) : (int)strlen(q);
                          memcpy(o, q, l); o[l] = 0; o += l + 1;
                          ++listLen; q += l + (c ? 1 : 0); }
                      listBuf = lbuf; break; }
                  default: break;
                }
              p = end;
            }
          oneWriteLine(vf, t, listLen, listBuf);
        }
      oneFileClose(vf);
      oneSchemaDestroy(vs);
      return 0;
    }
  if (!strcmp(argv[1], "read"))
    { if (argc != 5) return 2;
      char *schemaText = readAll(argv[2]);
      OneSchema *vs = oneSchemaCreateFromText(schemaText);
      OneFile *vf = oneFileOpenRead(argv[3], vs, argv[4], 1);
      if (!vf) { fprintf(stderr, "open read failed\n"); return 2; }
      char t;
      while ((t = oneReadLine(vf)))
        { OneType types[32]; int nField = 0;
          typeOfLine(vf, t, types, &nField);
          printf("%c", t);
          for (int i = 0; i < nField; ++i)
            switch (types[i])
              { case oneINT:  printf("\t%lld", (long long)oneInt(vf, i)); break;
                case oneREAL: printf("\t%la", oneReal(vf, i)); break;
                case oneCHAR: printf("\t%c", oneChar(vf, i)); break;
                case oneSTRING: case oneDNA:
                  printf("\t%.*s", (int)oneLen(vf), oneString(vf)); break;
                case oneINT_LIST:
                  { I64 *v = oneIntList(vf);
                    printf("\t");
                    for (I64 j = 0; j < oneLen(vf); ++j)
                      printf(j ? ",%lld" : "%lld", (long long)v[j]);
                    break; }
                case oneREAL_LIST:
                  { double *v = oneRealList(vf);
                    printf("\t");
                    for (I64 j = 0; j < oneLen(vf); ++j)
                      printf(j ? ",%la" : "%la", v[j]);
                    break; }
                case oneSTRING_LIST:
                  { char *s = oneString(vf);
                    printf("\t");
                    for (I64 j = 0; j < oneLen(vf); ++j)
                      { printf(j ? ",%s" : "%s", s);
                        s = oneNextString(vf, s); }
                    break; }
                default: break;
              }
          printf("\n");
        }
      oneFileClose(vf);
      oneSchemaDestroy(vs);
      return 0;
    }
  return 2;
}
